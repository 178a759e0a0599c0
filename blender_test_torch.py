# Render-device enumeration for the port's offline pipeline.
#
# Under Blender:  blender -b --python blender_test_torch.py
#   lists every Cycles device, as blender_test.py does.
# Standalone:     python blender_test_torch.py
#   bpy is unavailable outside Blender; lists the port's render backends
#   (render_torch.py: the numpy z-buffer preview, and Blender where it is on
#   PATH) and the CUDA devices torch sees, by name, with their count.

try:
    import bpy

    prefs = bpy.context.preferences.addons["cycles"].preferences
    prefs.get_devices()
    print("Cycles Devices:")
    for device in prefs.devices:
        print(f"  {device.name}: {device.type}")
except ImportError:
    import shutil

    print("bpy unavailable (not running under Blender)")
    print("Render backends (render_torch.py):")
    print("  preview: numpy z-buffer "
          "(sph_project_tpu_torch/io/render3d.py): CPU")
    blender = shutil.which("blender")
    print(f"  blender: {blender if blender else 'not on PATH'}")
    try:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"torch.cuda devices: {n}")
        for i in range(n):
            print(f"  cuda:{i}: {torch.cuda.get_device_name(i)}")
    except Exception as e:  # noqa: BLE001 — the listing must not crash
        print(f"  torch unavailable: {type(e).__name__}: {e}")
