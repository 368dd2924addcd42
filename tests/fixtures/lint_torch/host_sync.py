"""Fixture: HOST-SYNC — host synchronizations inside captured bodies."""
import numpy as np
import torch


def step(x, n):
    total = x.sum().item()  # BUG: .item()
    rows = x.tolist()  # BUG: .tolist()
    host = x.cpu()  # BUG: .cpu()
    arr = x.numpy()  # BUG: .numpy()
    moved = x.to("cpu")  # BUG: .to("cpu")
    scale = float(n)  # BUG: float() of a parameter
    pulled = np.asarray(x)  # BUG: np.asarray
    torch.cuda.synchronize()  # BUG: synchronize
    bound = torch.tensor(3, device=x.device)  # BUG: torch.tensor(device=)
    return total, rows, host, arr, moved, scale, pulled, bound


def graphed(x):
    def inner(y):
        return int(y)  # BUG: nested in a graphed callable
    return inner(x) + x.mean().item()  # BUG: .item() in a graphed callable


def capture(x, n):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step(x, n)
    return torch.cuda.make_graphed_callables(graphed, (x,))
