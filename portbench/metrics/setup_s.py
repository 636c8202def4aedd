"""End to end: seconds from the process's start to the first timed send:
imports, the deployment, the traffic's pool, the fill and the warm sends,
and any build of a kernel (``setup_built`` in the result line)."""


def read(run):
    return run.setup_s
