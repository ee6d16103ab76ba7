"""Generate the cross-path golden manifest (VERDICT r4 #6).

Renders ONE small scene (the r^2 insitu scene, RenderFromMultiFab.cpp:17-47)
through the full path matrix — raymarch / slicemarch / tilemarch x 1 / 8
devices x float32 / ubyte transport x pre-blend on / off — and stores the
resulting pixels in ``tests/golden/manifest_pixels.npz`` plus a
``tests/golden/manifest.json`` with the sha256 of each stored array.

tests/test_golden_manifest.py re-renders every path each suite run and
asserts against the stored pixels.  The per-run cross-path tests
(test_fuzz_cross_path) validate the paths against each other; this manifest
anchors them ACROSS rounds, so a pixel regression shared by all paths (which
the cross-checks cannot see) fails loudly.

Regenerate (ONLY after an intentional, reviewed pixel-semantics change):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      PYTHONPATH=. python scripts/generate_golden_manifest.py
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


WIDTH = HEIGHT = 48
OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden",
)


def render_matrix():
    """name -> [W*H, 5] float32 frame for every path in the matrix."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.camera import auto_orbit_camera
    from amrvolumerenderer_tpu.parallel.persistent import (
        MultiChipSceneRenderer,
    )
    from amrvolumerenderer_tpu.types import RenderParameters
    from tests.conftest import make_r2_scene_data

    import tempfile

    levels, geoms = make_r2_scene_data(16, 8)
    data = api.AmrData(level_data=levels, level_geometry=geoms)

    frames = {}
    tmp = tempfile.mkdtemp()

    def via_api(name, **opts):
        options = api.RenderOptions(
            width=WIDTH, height=HEIGHT,
            output_filename=os.path.join(tmp, f"{name}.ppm"), **opts
        )
        image, _ = api.render(data, options, verbose=False)
        frames[name] = np.array(image.pixels, np.float32)

    # single-device kernels
    via_api("raymarch-1dev", render_method="raymarch")
    via_api("slicemarch-1dev", render_method="slicemarch")
    via_api("tilemarch-1dev", render_method="tilemarch")

    # 8-device product pipelines
    via_api("slicemarch-8dev-depth-f32", devices=8,
            render_method="slicemarch", multichip_pipeline="depth")
    via_api("slicemarch-8dev-layered-f32", devices=8,
            render_method="slicemarch", multichip_pipeline="layered")
    via_api("slicemarch-8dev-depth-ubyte", devices=8,
            render_method="slicemarch", multichip_pipeline="depth",
            multichip_transport="ubyte")

    # 8-device persistent renderer, pre-blend exchange forced on AND off
    # (both folds must stay pixel-stable across rounds)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True,
                                     verbose=False)
    for name, force in (("persistent-8dev-preblend", True),
                        ("persistent-8dev-plain", False)):
        r = MultiChipSceneRenderer(
            geometry, RenderParameters(width=WIDTH, height=HEIGHT),
            num_devices=8,
        )
        r._use_preblend = lambda rmax, _force=force: _force
        cam = auto_orbit_camera(r.bounds)
        frames[name] = np.asarray(
            r.render(cam, overlay=False), np.float32
        )
    return frames


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) >= 8, (
        "run under XLA_FLAGS=--xla_force_host_platform_device_count=8"
    )
    frames = render_matrix()
    os.makedirs(OUT_DIR, exist_ok=True)
    npz_path = os.path.join(OUT_DIR, "manifest_pixels.npz")
    np.savez_compressed(npz_path, **frames)
    manifest = {
        "scene": "r2 insitu scene (make_r2_scene_data(16, 8))",
        "width": WIDTH,
        "height": HEIGHT,
        "atol": 2e-6,
        "paths": {
            name: {
                "sha256": hashlib.sha256(
                    np.ascontiguousarray(arr).tobytes()
                ).hexdigest(),
                "shape": list(arr.shape),
                "nonzero_alpha_frac": float((arr[:, 3] > 0).mean()),
            }
            for name, arr in frames.items()
        },
    }
    with open(os.path.join(OUT_DIR, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    for name, arr in frames.items():
        print(f"{name}: alpha>0 {float((arr[:, 3] > 0).mean()):.3f}")
    print("wrote", npz_path)


if __name__ == "__main__":
    main()
