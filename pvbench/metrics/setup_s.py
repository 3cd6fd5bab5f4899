"""setup_s: seconds from the process's start to the first timed frame handed
to the program (imports, the kernel library's build or load, the inputs, the
warm-up)."""

UNIT = "s"


def read(run):
    return run.setup_s
