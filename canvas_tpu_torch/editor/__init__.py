"""The editor's engine half on the port: plugin framework, document
model, undo commands and graph compilers (the counterpart of
``canvas_tpu.editor`` without its ``ui`` package).

Headless-first rebuild of the reference's fluggo.editor packages
(fluggo/editor/): Qt dependencies are replaced with
canvas_tpu_torch.signal signals, a JSON settings store, and a toolkit-free
undo stack, so the full editor model runs in CI and on render nodes. The
graph managers (``graph``) turn a project into the port's sources, which
``canvas_tpu_torch.render.RenderPlanner`` renders on the card; project
files load and save through ``yamlio``.
"""
