"""Set-up seconds spent writing the inputs' store with the reference's
one-batch store writer (the runner's phase ``store``)."""


def read(run):
    return dict(run["phases"]).get("store")
