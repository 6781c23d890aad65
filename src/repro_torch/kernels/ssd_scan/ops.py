"""Host-facing entry for the SSD chunk scan.

``ssd`` picks by the tensors' device: CUDA tensors launch the kernel
(``kernel.py``, which raises on what it cannot take) after padding the
sequence to a chunk multiple, CPU tensors take the plain version
(``ref.py``), any other device raises.  The kernel's outputs carry no
gradient, so ``ssd`` refuses inputs that require one, on every device (a
forward that would cut the graph on the card fails on the host too): a
training forward calls the plain version itself (``models/ssm.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..build import on_card
from .kernel import ssd_scan
from .ref import ssd_scan as ssd_scan_ref


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int, init_state=None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (b,l,h,p); dt (b,l,h) fp32; A (h,) fp32; Bm, Cm (b,l,n) in x's
    dtype; init_state (b,h,p,n) fp32 or None → (y (b,l,h,p) in x's dtype,
    final_state (b,h,p,n) fp32).  The chunk is ``min(chunk, l)``; padding
    rows carry dt = 0, so they leave the state as it is."""
    if any(t is not None and t.requires_grad
           for t in (x, dt, A, Bm, Cm, init_state)):
        raise ValueError("ssd_scan's kernel does not differentiate: its "
                         "outputs would cut the autograd graph; train "
                         "through the plain ssd_scan (ssm_block(..., "
                         "differentiable=True))")
    if not on_card(x, "ssd_scan"):
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state)
    l = x.shape[1]
    c = min(chunk, l) or 1
    pad = (-l) % c
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    y, state = ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                        Bm.contiguous(), Cm.contiguous(), chunk=c,
                        init_state=None if init_state is None
                        else init_state.float().contiguous())
    return y[:, :l], state
