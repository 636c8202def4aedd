"""Known-bad R1 fixture (torch): a tensor made, CUDA touched and a kernel
library built and loaded while the module is imported — each one breaks
an import on a host with no card, or initializes CUDA before the caller
chose a device."""

import ctypes

import torch

from siddhi_tpu_torch.ops import _cuda

BIG = torch.tensor(2 ** 62)             # makes a tensor at import
N_DEV = torch.cuda.device_count()       # touches CUDA at import
_cuda.build(["ring_exchange"])          # builds a kernel at import
LIB = ctypes.CDLL("siddhi_tpu_torch/_build/libring_exchange.so")
torch.set_default_device("cuda")        # process-wide default device
HAVE_CUDA = torch.cuda.is_available()   # fine: initializes nothing


def ok_inside_function():
    # lazy: making a tensor on the card here is fine
    return torch.zeros(3, device="cuda")


def bad_default(x=torch.ones(2).cuda()):    # defaults evaluate at import
    return x


class Holder:
    SCALE = torch.full((2,), 3.0)       # a class body runs at import


if __name__ == "__main__":
    torch.cuda.synchronize()            # a script entry point: fine
