"""inner_step_ms.train: the mean device time of one
``core.hwa.hwa_inner_step`` call (all K replicas' forward, backward and
SGD update) over the window, from the CUDA events the benchmark records
around each call."""


def read(ctx):
    ms = ctx["spans"].get("inner_step")
    return sum(ms) / len(ms) if ms else None
