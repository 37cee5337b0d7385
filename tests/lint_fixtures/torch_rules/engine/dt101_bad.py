"""DT101 bad: a kernel library and a CUDA graph built per call."""

import ctypes

import torch


def launch(path, x):
    return ctypes.CDLL(path).dyn_launch(x)


def load_each(paths):
    libs = []
    for p in paths:
        libs.append(ctypes.CDLL(p))
    return libs


def replay(step, x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(x)
    graph.replay()
