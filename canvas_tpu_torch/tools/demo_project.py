"""End-to-end editor demo (the counterpart of
``scripts/demo_project.py``): synthesize media, build a project, save
and reload it as YAML, compile the timeline, and export the result.

Exercises the whole stack in one pass, headless:

  1. ``write_video`` renders synthetic media to an AVI (the native
     ``canvas_av`` library, built on first use from ``native/``).
  2. ``EditorApp`` imports it through the libav source plugin.
  3. A space gets two clips of it, with an edit through the undo system.
  4. The project round-trips through YAML (save and reopen).
  5. ``SpaceEditor`` compiles the reloaded model to the engine graph and
     ``write_video`` exports the composite through the batched path.

The renders run on the card by default (``--device cpu``: the kernels'
plain versions on the host). Encoding and decoding need FFmpeg's
development files where the native library is built.

    python -m canvas_tpu_torch.tools.demo_project [WORKDIR] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

from canvas_tpu_torch.tools import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('workdir', nargs='?',
                    default=os.path.join(tempfile.gettempdir(),
                                         'canvas_demo'))
    add_device_argument(ap)
    args = ap.parse_args(argv)
    workdir = args.workdir
    os.makedirs(workdir, exist_ok=True)
    media_path = os.path.join(workdir, 'demo_media.avi')
    project_path = os.path.join(workdir, 'demo_project.yaml')
    out_path = os.path.join(workdir, 'demo_out.avi')

    from canvas_tpu_torch import libav, process
    from canvas_tpu_torch.basetypes import box2i
    from canvas_tpu_torch.editor import model
    from canvas_tpu_torch.editor import plugins as plugin_mod
    from canvas_tpu_torch.editor.settings import set_settings_path
    from canvas_tpu_torch.editor.ui.app import EditorApp

    window = box2i(0, 0, 319, 239)
    with on_device(args.device) as device:
        # 1. Synthesize source media
        ws = process.VideoWorkspace()
        ws.add(source=process.SolidColorVideoSource(
            process.LerpFunc((0.8, 0.2, 0.1, 1), (0.1, 0.2, 0.8, 1), 72)),
            x=0, length=72, z=0)
        libav.write_video(media_path, ws, None, 0, 72, frame_size=(320, 240),
                          video_codec='mpeg4', window=window, device=device)
        print('media:', media_path)

        # 2. Import through the plugin system (the libav plugins enabled;
        # enablement persists in the JSON settings store of the workdir)
        set_settings_path(os.path.join(workdir, 'settings.json'))
        plugin_mod.PluginManager.load_all()
        for p in plugin_mod.PluginManager.find_plugins(enabled_only=False):
            plugin_mod.PluginManager.set_plugin_enabled(p, True)

        app = EditorApp(device=device)
        app.import_file('demo', media_path)

        # 3. Build a timeline: two clips of the media
        editor = app.new_space('main')
        app.add_asset_to_space(editor, 'demo', x=0, length=36)
        (clip2,) = [i for i in app.add_asset_to_space(
            editor, 'demo', x=36, length=36) if i.type() == 'video']
        clip2.update(offset=36)
        # move the second clip with an undoable command, then undo/redo it
        cmd = model.MoveItemCommand(clip2, x=40, y=clip2.y)
        editor.undo_stack.push(cmd)
        editor.undo_stack.undo()
        editor.undo_stack.redo()
        assert clip2.x == 40

        # 4. YAML round trip
        app.save_file(project_path)
        print('project:', project_path)
        app2 = EditorApp(device=device)
        app2.open_file(project_path)
        editor2 = app2.open_space('main')

        # 5. Compile and export through the batched path
        libav.write_video(out_path, editor2.video_stream, None, 0, 76,
                          frame_size=(320, 240), video_codec='mpeg4',
                          window=window, device=device)
        app.close()
        app2.close()
    cont = libav.AVContainer(out_path)
    info = cont.streams[0]
    cont.close()
    print('export:', out_path, info.codec, info.frame_size,
          info.frame_count, 'frames')
    assert info.frame_count == 76
    print('demo OK')
    return 0


if __name__ == '__main__':
    sys.exit(main())
