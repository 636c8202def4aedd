"""Known-bad R5 fixture (torch): host pulls inside step bodies — each one
a synchronous device-to-host round trip a batch, and a break in the
step's CUDA-graph capture."""

import numpy as np
import torch

from siddhi_tpu_torch.analysis.sanitize import allowed_pull


def build_step_fn(plan):
    def step(state, cols, now):
        total = float(state["sum"])                 # scalar pull
        count = state["count"].item()               # .item() pull
        host = np.asarray(cols["price"].cpu())      # whole-column pulls
        if bool(state["overflow"]):                 # control-flow pull
            total = 0.0
        ids = cols["ids"].tolist()                  # list pull
        torch.cuda.synchronize()                    # stalls the host
        n = int(cols["price"].shape[0])             # static: fine
        with allowed_pull():
            seen = state["seen"].item()             # sanctioned: fine
        return state, {"t": total, "c": count, "h": host, "i": ids,
                       "n": n, "s": seen}

    return step


def wire(tel):
    def body(state, cols, now):
        return state, {"x": cols["x"].numpy()}      # handed to the instrument

    return tel.instrument_jit(body, "bad.body")


class EagerStage:
    # never captured: its step reads the host on purpose
    capturable = False

    def build(self):
        def step(state, cols, now):
            return int(state["live"])               # sanctioned: fine

        return step
