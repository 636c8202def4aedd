"""End to end: the 95th percentile, over every send of the window, of the
time from the producer's call (when a closed loop's batch is due) to the
arrival of its last output row at the callback, in ms."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3
