"""setup_s: seconds from the start of the process to the first timed op
or epoch (imports, kernel library, cluster boot or map build, prefill,
warm-up)."""


def read(run):
    return run.setup_s
