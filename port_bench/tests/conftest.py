"""Few threads per test process: the tests run in parallel workers."""

import torch

torch.set_num_threads(2)
