"""One torch intra-op thread in a test process.

pytest-xdist runs several workers on the host's cores, and torch's default
(an intra-op thread a core, in every worker) oversubscribes them: the
OpenMP threads spin against each other and small ops crawl. A CartPole PPO
run of 30 iterations took 94 s beside 7 busy processes on 8 cores with the
default, 11 s with one thread. Every port test module imports this; the
processes the tests start get ``OMP_NUM_THREADS=1`` from their fixtures.
"""

import torch

torch.set_num_threads(1)
