"""Set-up: host seconds of the program's ptyrad.setup.optimizer span
(create_optimizer and a resumed state's load, where the first
torch.optim.Adam imports torch._dynamo), from the program's own table."""

from benchmark.spans import host_seconds


def read(rec):
    return host_seconds("ptyrad.setup.optimizer")
