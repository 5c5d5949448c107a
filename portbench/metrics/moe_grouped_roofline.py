"""moe_grouped_roofline (%, device trace): the least time the card needs
for the expert products of the window (routed and shared, one grouped
product of gate and up and one of down in each expert layer's call),
over the device time of the kernels named below.  Counted from the
program's expert counter (``models/moe_text.py:expert_counts``): the
tokens routed to each expert and the experts that took at least one
token, per expert layer, and the window's searches, which set each
layer's calls (``work/moe.py``).  The products run as
``torch._grouped_mm``, whose kernels on the H100 are CUTLASS's grouped
GEMM."""

from portbench.work import bound_s, moe

KERNELS = ("GroupProblemShape", "grouped_gemm", "GroupedGemm",
           "KernelPtrArray")


def read(run):
    experts = run.counts.get("experts")
    if run.timeline is None or not experts or not run.counts["searches"]:
        return None
    kernel_s = run.timeline.kernel_s(KERNELS)
    if kernel_s <= 0:
        return None
    calls = moe.layer_calls(run.counts["searches"], run.traffic["max_words"])
    need = sum(bound_s(*moe.cost(run.config, sum(tokens), active, calls),
                       run.peaks)
               for tokens, active in zip(experts["tokens"],
                                         experts["active"]))
    return 100.0 * need / kernel_s
