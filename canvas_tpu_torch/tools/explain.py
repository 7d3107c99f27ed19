"""Print a render-plan report for a project's space (the counterpart of
``scripts/explain.py``).

Loads the project headless (``EditorApp`` without a toolkit), resolves
the space's live video stream through the same graph managers the
editor uses, and prints ``RenderPlanner.explain`` for the range: the IR
tree per segment (ops, static geometry, param shapes, window coverage),
whether a render program of the segment is captured and live, and the
caches. With ``--demo`` (or no project) the headline 10-layer 1080p
timeline instead (``timelines.build_timeline(1024)``).

    python -m canvas_tpu_torch.tools.explain PROJECT.yaml [--space NAME]
        [--start N] [--stop N] [--device cpu]
    python -m canvas_tpu_torch.tools.explain --demo [--device cpu]
"""

import argparse
import sys

from canvas_tpu_torch.tools import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('project', nargs='?', help='PROJECT.yaml')
    ap.add_argument('--space', help='space asset name (default: first)')
    ap.add_argument('--start', type=int, default=0)
    ap.add_argument('--stop', type=int, default=None)
    ap.add_argument('--demo', action='store_true',
                    help='explain the headline 10-layer 1080p timeline')
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from canvas_tpu_torch.basetypes import box2i
    from canvas_tpu_torch.render import RenderPlanner

    with on_device(args.device) as device:
        if args.demo or not args.project:
            from canvas_tpu_torch.timelines import build_timeline
            stop = args.stop if args.stop is not None else args.start + 64
            planner = RenderPlanner(build_timeline(1024),
                                    box2i(0, 0, 1919, 1079), device=device)
            try:
                print(planner.explain(args.start, stop))
            finally:
                planner.close()
            return 0

        from canvas_tpu_torch.editor import model, plugins
        from canvas_tpu_torch.editor.ui.app import EditorApp

        # A headless one-shot: every discovered plugin enabled IN MEMORY,
        # so media refs resolve without touching the user's persisted
        # plugin choices.
        plugins.PluginManager.enable_all_for_session()
        app = EditorApp(device=device)
        try:
            app.open_file(args.project)
            names = [name for name, asset in app.asset_list.items()
                     if isinstance(asset, model.SpaceAsset)]
            if not names:
                print('no space assets in %s' % args.project,
                      file=sys.stderr)
                return 1
            name = args.space or names[0]
            editor = app.open_space(name)
            fmt = editor.space.video_format
            w, h = fmt.full_frame.width, fmt.full_frame.height
            length = max((it.x + it.length for it in editor.space),
                         default=64)
            stop = (args.stop if args.stop is not None
                    else min(length, args.start + 64))
            print('space %r  %dx%d  frames [%d, %d)'
                  % (name, w, h, args.start, stop))
            planner = RenderPlanner(editor.video_stream,
                                    box2i(0, 0, w - 1, h - 1), device=device)
            try:
                print(planner.explain(args.start, stop))
            finally:
                planner.close()
        finally:
            app.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
