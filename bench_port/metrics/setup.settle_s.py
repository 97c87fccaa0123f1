"""Set-up seconds from the viewer's first update to the window: the view
settled at the first pose and the warm frames rendered (the runner's
phases ``settle`` and ``warm``). The kernels are built and loaded before,
in a phase of their own (``build``), so a checkout's first run reads the
viewer's work alone too."""


def read(run):
    phases = dict(run["phases"])
    if "settle" not in phases:
        return None
    return phases["settle"] + phases.get("warm", 0.0)
