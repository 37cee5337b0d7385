"""DT101 good: the library and the graph are built once and kept."""

import ctypes
import functools

import torch

_lib = None


def library(path):
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(path)
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def cached(path):
    return ctypes.CDLL(path)


class Runner:
    def __init__(self, step, x):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            step(x)

    def rebuild(self, step, x):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            step(x)

    def run(self):
        self.graph.replay()
