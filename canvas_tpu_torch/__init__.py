"""Canvas on PyTorch and CUDA: the device side of ``canvas_tpu`` ported
to an NVIDIA Hopper GPU.

The host side (sources, frame functions, the render planner's NumPy
planning) is reused from ``canvas_tpu`` by import; this package holds
only what runs on the device:

- ``backend``: device resolution, host-to-device transfer, math mode;
- ``ops.cuda_ops``: the hand-written CUDA kernels (``csrc/``) and their
  plain PyTorch versions;
- ``ops.study_ops``: the CUDA kernels of the fold studies and the
  roofline probe, beside their plain versions;
- ``studies``: the port's counterparts of the TPU studies in
  ``scripts/`` (fold variants, per-tile layer lists, the roofline);
- ``ops.color``: f16 quantizers and transfer curves;
- ``staging``: pipelined host-to-device staging on pinned memory;
- ``plan``: the planning context, with the port's own device staging;
- ``coded``: device staging of coded DV planes;
- ``render``: the torch evaluator of the planner's IR and a
  ``RenderPlanner`` that streams batches through it.

Nothing here imports JAX.
"""
