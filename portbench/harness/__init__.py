"""The benchmark's own machinery: finding cells by name, the measured window,
the profiler's sub-window and its reduction, the result line."""
