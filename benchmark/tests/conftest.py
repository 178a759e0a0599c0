"""The harness's tests run on the CPU: the benchmark's modules and the
repository root on the path, torch on one thread."""
import os
import sys

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]
torch.set_num_threads(1)
