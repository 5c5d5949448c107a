"""The benchmark's general machinery: cells, the window, the trace."""
