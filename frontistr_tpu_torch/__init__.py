"""frontistr_tpu_torch — the PyTorch/CUDA port of frontistr_tpu.

A second package beside the JAX one, ported slice by slice and held to it
by the ``tests/test_torch_*.py`` parity tests.  The first slice is the
linear-elastic STATIC analysis of tet meshes: read ``hecmw_ctrl.dat`` ->
``.msh``/``.cnt``, RCM reorder, element stiffness, cluster-ELL assembly
through the hand-written CUDA segment-sum kernel
(``assembly/segsum.py`` + ``csrc/segsum.cu``), AMG-preconditioned
mixed-precision CG, stress recovery and the ``0.log`` summary.

It imports torch and numpy, never JAX: the JAX package's ``__init__``
turns on x64 globally, so no ``frontistr_tpu`` module is imported here
either (the host-only ones are copies).
"""

__version__ = "0.1.0"
