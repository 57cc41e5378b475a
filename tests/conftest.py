"""Test config: force CPU with 8 virtual devices (sharding tests run on a
virtual mesh; SURVEY.md section 4).

The CPU is forced with ``jax.config.update`` before first backend use, so
the suite never touches an accelerator, whatever ``JAX_PLATFORMS`` says.
The one exception is a run that selects only the card tier
(``python -m pytest tests/test_gpu.py -m gpu``, which chip_smoke.py runs on
the GPU): it keeps the real backend.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import gc
import pathlib
import tempfile

import jax

import numpy as np
import pytest


def pytest_configure(config):
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """XLA's CPU backend segfaults inside backend_compile after enough
    large compilations accumulate in one process (reproduced twice in the
    round-5 full suite around the 150th test, each kernel fine in
    isolation).  Dropping compiled executables between test modules keeps
    the live-compilation footprint bounded; device arrays (session-scoped
    scene fixtures) are unaffected."""
    yield
    jax.clear_caches()
    gc.collect()

REPO = pathlib.Path(__file__).resolve().parents[1]
# in-repo scenes: a minimal quad/triangle/sphere scene and the Whitted
# Cornell box (mirror + conductor walls, dielectric sphere)
SIMPLE_XML = REPO / "tests" / "data" / "simple.xml"
WHITTED_XML = REPO / "scenes" / "cornell_whitted.xml"

# The reference C++ renderer's checkout (dorukb/Advanced-CPU-Raytracing),
# for the golden-image tests: not part of this repository.  Place or link
# it at ./reference to run them; they skip when it is absent.
REFERENCE = REPO / "reference"
HW1_INPUTS = REFERENCE / "archive" / "hw1_inputs"
HW1_OUTPUTS = REFERENCE / "archive" / "hw1_outputs"


@pytest.fixture
def reference_inputs():
    """The reference repo's archived scene directory; skips the test when
    the reference checkout is absent."""
    if not HW1_INPUTS.is_dir():
        pytest.skip(f"reference scenes not present ({HW1_INPUTS})")
    return HW1_INPUTS


@pytest.fixture(scope="session")
def simple_scene():
    from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene

    return load_scene(str(SIMPLE_XML))


@pytest.fixture(scope="session")
def simple_pack(simple_scene):
    from advanced_cpu_raytracing_tpu.scene.pack import pack_scene

    return pack_scene(simple_scene)


def _read_rgb(path) -> np.ndarray:
    from advanced_cpu_raytracing_tpu.scene.images import load_image

    return load_image(str(path))[0].astype(np.uint8)


def golden_image(name: str) -> np.ndarray:
    return _read_rgb(HW1_OUTPUTS / f"{name}.png")


# ---------------------------------------------------------------------------
# Fresh golden renders: the archived hw1_outputs were produced by older
# homework iterations of the reference (e.g. cornellbox_recursive_alt2.png
# predates its current camera), so where possible we compile the reference's
# CURRENT source and render the scene fresh, caching the result.
# ---------------------------------------------------------------------------

_REF_BIN_CACHE = pathlib.Path(tempfile.gettempdir()) / "acrt_ref" / "raytracer"
_GOLDEN_CACHE = pathlib.Path(tempfile.gettempdir()) / "acrt_ref" / "golden"


def _reference_binary() -> pathlib.Path | None:
    import shutil
    import subprocess

    if _REF_BIN_CACHE.exists():
        return _REF_BIN_CACHE
    src = REFERENCE / "src"
    if not src.exists() or shutil.which("g++") is None:
        return None
    build = _REF_BIN_CACHE.parent / "build"
    build.mkdir(parents=True, exist_ok=True)
    for f in src.glob("*.cpp"):
        shutil.copy(f, build)
    for f in list(src.glob("*.h")) + list(src.glob("*.hpp")):
        shutil.copy(f, build)
    try:
        subprocess.run(
            ["g++"] + [str(p) for p in sorted(build.glob("*.cpp"))]
            + ["-o", str(_REF_BIN_CACHE), "-std=c++11", "-O2", "-lpthread"],
            check=True, capture_output=True, timeout=600,
        )
    except Exception:
        return None
    return _REF_BIN_CACHE if _REF_BIN_CACHE.exists() else None


def fresh_golden(name: str) -> np.ndarray | None:
    """Render the scene with the reference's current code (cached);
    None if unavailable."""
    import shutil
    import subprocess

    out = _GOLDEN_CACHE / f"{name}.png"
    if out.exists():
        return _read_rgb(out)
    binary = _reference_binary()
    if binary is None:
        return None
    scene = HW1_INPUTS / f"{name}.xml"
    if not scene.exists():
        return None
    _GOLDEN_CACHE.mkdir(parents=True, exist_ok=True)
    work = _GOLDEN_CACHE / f"_work_{name}"
    work.mkdir(exist_ok=True)
    shutil.copy(scene, work / scene.name)
    try:
        subprocess.run([str(binary), scene.name], cwd=work, check=True,
                       capture_output=True, timeout=1200)
    except Exception:
        return None
    produced = work / f"{name}.png"
    if not produced.exists():
        pngs = list(work.glob("*.png"))
        if not pngs:
            return None
        produced = pngs[0]
    shutil.move(str(produced), out)
    shutil.rmtree(work, ignore_errors=True)
    return _read_rgb(out)


def fresh_golden_custom(name: str, xml_text: str, aux_files: dict | None = None):
    """Render an AUTHORED scene through the freshly-built reference binary.

    The reference ships no scenes for PT / textures / DoF / tonemap /
    spot+directional lights (SURVEY.md section 0.2), so cross-validation
    scenes are authored here, rendered by the reference's own compiled code,
    and cached.  ``aux_files`` maps work-dir-relative paths (e.g.
    "inputs/tex.png") to bytes.  Returns (scene_path, {suffix: ndarray})
    with the produced .png (uint8 RGB) and .hdr (float RGB) images, or
    (scene_path, None) when the binary is unavailable.
    """
    import shutil
    import subprocess

    # cache key includes the scene content: re-authored scenes must not hit
    # a stale oracle
    import hashlib

    digest = hashlib.sha1(
        xml_text.encode()
        + b"".join(sorted((aux_files or {}).keys())[i].encode()
                   for i in range(len(aux_files or {})))
    ).hexdigest()[:10]
    name = f"{name}_{digest}"
    scene_dir = _GOLDEN_CACHE / "custom_scenes" / name
    scene_dir.mkdir(parents=True, exist_ok=True)
    scene_path = scene_dir / f"{name}.xml"
    scene_path.write_text(xml_text)
    for rel, data in (aux_files or {}).items():
        p = scene_dir / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)

    out_png = _GOLDEN_CACHE / f"custom_{name}.png"
    out_hdr = _GOLDEN_CACHE / f"custom_{name}.hdr"
    failed = _GOLDEN_CACHE / f"custom_{name}.FAILED"
    if failed.exists():
        return scene_path, None
    if not out_png.exists():
        binary = _reference_binary()
        if binary is None:
            return scene_path, None
        try:
            subprocess.run([str(binary), scene_path.name], cwd=scene_dir,
                           check=True, capture_output=True, timeout=300)
        except Exception:
            # cache the failure: the reference hangs on some authored scenes
            # (e.g. tower_smooth at ANY resolution) and re-timing out every
            # run would dominate the suite
            failed.write_text("reference binary failed or timed out")
            return scene_path, None
        pngs = sorted(scene_dir.glob("*.png"))
        if not pngs:
            return scene_path, None
        for p in pngs:
            shutil.move(str(p), _GOLDEN_CACHE / f"custom_{name}__{p.name}")
        shutil.copy(_GOLDEN_CACHE / f"custom_{name}__{pngs[0].name}", out_png)
        hdrs = list(scene_dir.glob("*.hdr"))
        if hdrs:
            shutil.move(str(hdrs[0]), out_hdr)

    result = {"png": _read_rgb(out_png)}
    # multi-camera scenes: every produced image, keyed by its file name
    result["pngs"] = {
        p.name.split("__", 1)[1]: _read_rgb(p)
        for p in _GOLDEN_CACHE.glob(f"custom_{name}__*.png")
    }
    if out_hdr.exists():
        from advanced_cpu_raytracing_tpu.scene.images import read_hdr

        result["hdr"] = read_hdr(str(out_hdr))
    return scene_path, result
