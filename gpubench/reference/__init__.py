"""The plain reference the benchmark judges the program's frames by.

``compose.Renderer.frame`` composites one frame of a configuration with
plain PyTorch operations in the order the pull path's NumPy arms take
(``SolidColorVideoSource``, ``VideoGainOffsetFilter``, ``VideoScaler``,
``VideoMixFilter``, ``DVReconstructionFilter``, ``VideoWorkspace``), in
f32 with TF32 off, and rounds the result to f16 once; ``post.yuv420``
packs it as the export's studio-range 4:2:0; a layer kind or a post of
a configuration's own is a file of ``layers/`` or ``posts/`` here
(``compose.LAYERS_DIR``, ``check.POSTS_DIR``). ``tables`` builds the f16
transfer and display-level tables with libm's ``powf``. Nothing here
imports the program, JAX or the JAX package.
"""
