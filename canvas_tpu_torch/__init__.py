"""Canvas on PyTorch and CUDA: ``canvas_tpu`` ported to an NVIDIA Hopper
GPU. The package stands on its own: it imports nothing of ``canvas_tpu``
and keeps its own copy of the host side it needs. Its public import is
``canvas_tpu_torch.process``.

Host side (the JAX package's host code, copied module for module):

- ``basetypes``, ``framefuncs``, ``frames``, ``sources``, ``coded``:
  sources, filters and frames with their eager pull path and their
  emitters;
- ``ir``: the planner's ``Node`` IR, signatures and window algebra;
- ``plan``: the planning context and the persistent stage cache;
- ``ops.window``, ``ops.mix``, ``ops.scale``, ``ops.chroma`` and
  ``ops.color``: the pull path's pixel math, each op with a NumPy arm
  and a plain torch arm (the JAX arm's form), and the planner's tap
  builders;
- ``profiling``: the planner's stage timers and a ``torch.profiler``
  trace;
- ``timelines``: the headline and mixed-content timelines;
- ``clock``, ``signal``: presentation clocks and the weakref signal a
  source's ``frames_updated`` is.
- ``audio``: the audio engine (frames, mixing helpers, sequence,
  workspace); ``formats``, ``timecode``, ``matroska``: probes, timecode
  strings and the Matroska writer; ``x264``, ``faac``, ``libdv``: the
  reference's codec classes over ``libav``.

Device side:

- ``backend``: the eager pull's thread-local backend mode (``'auto'``:
  frames of 16,384 pixels or more run the torch arms of the pixel ops
  on the card), device resolution, host-to-device transfer, math mode;
- ``ops.cuda_ops``: the hand-written CUDA kernels (``csrc/``) and their
  plain PyTorch versions;
- ``ops.study_ops``: the CUDA kernels of the fold studies and the
  roofline probe, beside their plain versions;
- ``studies``: the port's counterparts of the TPU studies in
  ``scripts/`` (fold variants, per-tile layer lists, the roofline);
- ``ops.color``: f16 quantizers, transfer curves, export conversions and
  display transports;
- ``staging``: pipelined host-to-device staging on pinned memory;
- ``render``: the torch evaluator of the planner's IR and a
  ``RenderPlanner`` that streams batches through it (over a device mesh
  too: ``iter_batches(mesh=)``, ``render_sharded``) and pulls single
  display frames (``render_display``);
- ``mesh``: device meshes (a device may stand in one more than once),
  replicated staged stacks and frames sharded over a mesh;
- ``playback``: the clock-driven ``VideoPlaybackEngine``;
- ``libav``: media IO over the port's own build of
  ``native/canvas_av.cpp`` (demux, decode, mux, packet encoders), and
  ``write_video``, which renders through ``render`` on the card and
  encodes on the host.

Nothing here imports JAX.
"""

NS_PER_SEC = 1000000000
