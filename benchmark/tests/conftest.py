"""Under xdist several of these CPU tests share a machine: two torch
threads a worker (and in the processes they start) keep them from
starving each other's time-bound windows."""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    os.environ["OMP_NUM_THREADS"] = "2"
    torch.set_num_threads(2)
