"""Set-up: imports, the CUDA context, the kernel library, the problem from
the seed and one warm-up unit, by the host's clock (s)."""


def read(run):
    return run.setup_s
