"""Hardware constants for the roofline model: one NVIDIA H100 SXM5 80 GB,
the card ``chip_smoke.py`` prints as "NVIDIA H100 80GB HBM3, 700.00 W".

Every value is NVIDIA's data sheet (dense rates, no sparsity, at the full
700 W power limit), not a measurement.  A card set below 700 W runs slower
under load.

The roofline's collective term divides a device's collective bytes by one
link rate, as the reference does.  That rate is ``LINK_BW``, the
InfiniBand rate between nodes: the production mesh's 16-wide ``model``
axis spans two 8-GPU NVLink nodes (``launch/mesh.py``), so its collectives
cross InfiniBand.
"""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s per GPU, dense bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s per GPU, fp32 without tensor cores
HBM_BW = 3.35e12              # B/s per GPU, HBM3
HBM_PER_CHIP = 80e9           # B of HBM3 per GPU
GPUS_PER_NODE = 8
NVLINK_BW = 450e9             # B/s per GPU per direction, NVLink 4
IB_BW = 50e9                  # B/s per GPU between nodes, 400 Gb/s InfiniBand
LINK_BW = IB_BW               # the roofline's collective term (docstring)
