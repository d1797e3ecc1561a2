"""Seconds from the process's start to the end of set-up: CUDA, the kernel
library, the inputs, analysis, plan and the executor's warmup."""


def read(ctx):
    return ctx.setup_s
