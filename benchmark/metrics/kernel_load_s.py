"""Set-up: host seconds of the program's ptyrad.setup.kernels span (the
kernel library's first load: the sources' hash, any build, the load and
its argtypes), from the program's own table."""

from benchmark.spans import host_seconds


def read(rec):
    return host_seconds("ptyrad.setup.kernels")
