"""Set-up seconds spent drawing the cell's inputs from the seed and
decoding them (the runner's phase ``inputs``: gen.py, scenes/<kind>.py)."""


def read(run):
    return dict(run["phases"]).get("inputs")
