"""The port's CPU tests run torch on one intra-op thread.

Tier-1 runs six pytest-xdist workers at once on the machine's cores. At
torch's default of one OpenMP thread a core, the workers' thread pools
spin against one another: on an 8-core machine, six copies of
test_torch_moe_int4.py::test_int4_moe_chat_matches_jax_over_two_turns
started together took 982 s each, against 35 s for one copy alone and
78 s each with one thread. Every ``tests/test_torch_*.py`` imports this
module, so a worker that collects any of them (each collects them all)
runs torch on one thread from the start.
"""

import torch

torch.set_num_threads(1)
