"""Replaying the reference's plain operations as CUDA graphs.

The reference's SGM runs some 18,000 small operations a frame and a
relaxation sweep some 1,300; launched one by one from Python they take most
of a run's reference time.  On a card, ``Replay`` runs a function once
eagerly (its first result, and the warm-up of every kernel and allocation),
captures the same operations into a CUDA graph over static copies of the
inputs, and replays that graph on later calls.  A graph launches exactly
the kernels the eager call launched, on the same shapes, so the values are
the eager ones.  On the CPU the function runs eagerly every time.
"""

from __future__ import annotations

from typing import Callable

import torch


class Replay:
    """`fn` of tensors of fixed shapes.  The outputs of a replayed call are
    the graph's static tensors: the next call overwrites them, so a caller
    that keeps them clones them."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graph = None
        self.inputs: list[torch.Tensor] = []
        self.outputs = None

    def __call__(self, *args: torch.Tensor):
        if args[0].device.type != "cuda":
            return self.fn(*args)
        if self.graph is None:
            out = self.fn(*args)
            self.inputs = [a.clone() for a in args]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = self.fn(*self.inputs)
            return out
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        return self.outputs


class RepeatInPlace:
    """`step(*state, *consts)` -> new state, run `n` times: on a card, one
    step is captured with the new state copied back into static state
    buffers, and the graph is replayed n times."""

    def __init__(self, step: Callable):
        self.step = step
        self.graph = None
        self.state: list[torch.Tensor] = []
        self.consts: list[torch.Tensor] = []

    def __call__(self, n: int, state: tuple, consts: tuple) -> tuple:
        if state[0].device.type != "cuda" or n == 0:
            for _ in range(n):
                state = self.step(*state, *consts)
            return tuple(state)
        if self.graph is None:
            state = self.step(*state, *consts)
            n -= 1
            self.state = [s.clone() for s in state]
            self.consts = [c.clone() for c in consts]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                for static, new in zip(self.state, self.step(*self.state, *self.consts)):
                    static.copy_(new)
        for static, s in zip(self.state + self.consts, (*state, *consts)):
            static.copy_(s)
        for _ in range(n):
            self.graph.replay()
        return tuple(s.clone() for s in self.state)
