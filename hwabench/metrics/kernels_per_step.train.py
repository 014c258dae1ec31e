"""kernels_per_step.train: device operations (kernels, copies, fills)
in the traced slice of the window, per inner step, syncs included: the
eager optimizer's and the dtype casts' traffic shows here."""


def read(ctx):
    steps = ctx["window"]["traced"]["steps"]
    if not ctx.get("trace") or not steps:
        return None
    return len(ctx["trace"]["kernels"]) / steps
