"""Fixture: TRACED-BRANCH — Python control flow on a tensor parameter
inside a captured body."""
import torch


class Stepper:
    def body(self, x, thresh):
        if x.sum() > thresh:  # BUG: branch on a tensor
            x = x * 2
        while x.max() > 1:  # BUG: loop on a tensor
            x = x / 2
        return x

    def capture(self, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            self.body(x, 0.5)
        return g
