"""setup_s: process start to the first timed call: imports, the kernels'
build (a checkout's first run) or load, weights made from the seed, the
Engine built, the warm-up calls."""


def read(rec):
    return rec["setup_s"]
