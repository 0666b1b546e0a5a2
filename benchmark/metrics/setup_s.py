"""setup_s: seconds from the process's start to the window's (imports,
the CUDA context, kernel builds, weights, inputs and warm-up)."""


def read(rec):
    return rec["setup_s"]
