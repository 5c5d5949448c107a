"""One module per kind of work a traffic mix can name (``"driver"``).

``setup(ctx)`` builds the program's objects from ``ctx.seed`` and warms up
every shape its window uses, and returns an object with ``unit()`` (one
timed unit of work, ending in a synchronize), ``counts()`` (what the
window did: ``attempted``, ``failed`` and the counts its metrics read),
``release()`` (frees the program's state) and ``check()`` (the numbers
compared with the plain reference, each beside its limit).
"""
