"""Process start to the first timed request or step.  Host clock."""


def read(run):
    return run.get("setup_s")
