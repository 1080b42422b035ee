"""The port's data layer against the JAX package's, on the CPU.

- `make_dataset` over each dataset's on-disk layout, written in tmp_path:
  K, ground truth and the image list exactly equal to the JAX package's.
- The native decoder (the port's copy of the C++ sources, built at first
  use) bit-equal to the JAX package's on gray, RGB and RGBA PNG, PGM, a
  baseline JPEG and in `decode_batch` with 4 threads; a file the native
  parser rejects takes the PIL route in both; a failed build raises with
  the compiler's output; processes that build at once all succeed.
- `PrefetchLoader`: order and content, a worker that stops when the
  consumer breaks off, a decode error raised to the consumer.
- `render_textured_image(texture="photo")` equal to the JAX package's.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from visualodometry_tpu.data import loaders as jloaders
from visualodometry_tpu.data import native_decode as jnative
from visualodometry_tpu.data import synthetic as jsyn
from visualodometry_tpu_torch.data import loaders, native_decode, prefetch, synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- loaders ---------------------------------------------------------------

def _poses(path, n, rng):
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, rng.normal(size=(n, 12)))


def _touch(d, names):
    d.mkdir(parents=True, exist_ok=True)
    for n in names:
        (d / n).write_bytes(b"")


def _make_tree(name, root, rng):
    if name == "kitti":
        _touch(root / "kitti" / "05" / "image_0", ["000002.png", "000000.png", "000001.png", "x.jpg"])
        _poses(root / "kitti" / "poses" / "05.txt", 3, rng)
    elif name == "malaga":
        d = root / "malaga" / "malaga-urban-dataset-extract-07_rectified_800x600_Images"
        _touch(d, ["b_left.jpg", "a_left.jpg", "a_right.jpg"])
    else:
        sub, ext = ("parking", "png") if name == "parking" else ("my_dataset", "jpg")
        _touch(root / sub / "images", [f"img_{i:05d}.{ext}" for i in (3, 1, 2)])
        K = np.array([[500.0, 0, 320.5], [0, 501.0, 240.25], [0, 0, 1]])
        (root / sub / "K.txt").write_text(
            "\n".join(", ".join(repr(float(v)) for v in row) for row in K) + "\n"
        )
        if name == "parking":
            _poses(root / sub / "poses.txt", 3, rng)


@pytest.mark.parametrize("name", ["kitti", "malaga", "parking", "own"])
def test_make_dataset_equals_jax(name, tmp_path, rng):
    _make_tree(name, tmp_path, rng)
    a = loaders.make_dataset(name, tmp_path, sequence="05")
    b = jloaders.make_dataset(name, tmp_path, sequence="05")
    np.testing.assert_array_equal(a.K, b.K)
    if b.ground_truth is None:
        assert a.ground_truth is None
    else:
        np.testing.assert_array_equal(a.ground_truth, b.ground_truth)
    assert a.image_files == b.image_files and len(a) == len(b) == (2 if name == "malaga" else 3)


def test_unknown_dataset_raises_in_both(tmp_path):
    for mod in (loaders, jloaders):
        with pytest.raises(ValueError):
            mod.make_dataset("tum", tmp_path)


# ---- native decoder ---------------------------------------------------------

@pytest.fixture(scope="module")
def jlib():
    lib = jnative.get_lib()
    if lib is None:
        pytest.skip("the JAX package's native decoder did not build")
    return lib


def _image(kind, rng):
    if kind == "png_gray":
        return rng.integers(0, 256, (37, 53), dtype=np.uint8), "L", "png"
    if kind == "png_rgb":
        return rng.integers(0, 256, (24, 31, 3), dtype=np.uint8), "RGB", "png"
    if kind == "png_rgba":
        return rng.integers(0, 256, (20, 33, 4), dtype=np.uint8), "RGBA", "png"
    # a baseline JPEG of the photo texture
    scene = synthetic.make_scene(rng, num_frames=1, image_size=(96, 64), num_landmarks=2)
    img = synthetic.render_textured_image(scene, 0, texture="photo")
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8), "L", "jpg"


def _write(path, arr, mode):
    kw = {"quality": 90} if path.suffix == ".jpg" else {}
    Image.fromarray(arr, mode=mode).save(path, **kw)


@pytest.mark.parametrize("kind", ["png_gray", "png_rgb", "png_rgba", "jpeg_photo", "pgm"])
def test_decode_gray_bit_equal_to_jax(kind, tmp_path, rng, jlib):
    if kind == "pgm":
        arr = rng.integers(0, 256, (16, 20), dtype=np.uint8)
        p = tmp_path / "i.pgm"
        p.write_bytes(b"P5\n# comment\n20 16\n255\n" + arr.tobytes())
    else:
        arr, mode, ext = _image(kind, rng)
        p = tmp_path / f"i.{ext}"
        _write(p, arr, mode)
    assert native_decode.image_info(p) == jnative.image_info(p) == (arr.shape[1], arr.shape[0])
    native_decode.routes.update(native=0, pil=0)
    out = native_decode.decode_gray(p)
    assert native_decode.routes == {"native": 1, "pil": 0}
    ref = jnative.decode_gray(p)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_decode_batch_bit_equal_to_jax(tmp_path, rng, jlib):
    paths = []
    for i in range(12):
        p = tmp_path / f"f{i:02d}.png"
        _write(p, rng.integers(0, 256, (40, 60), dtype=np.uint8), "L")
        paths.append(p)
    native_decode.routes.update(native=0, pil=0)
    out, n_ok = native_decode.decode_batch(paths, w=60, h=40, threads=4)
    ref, n_ref = jnative.decode_batch(paths, w=60, h=40, threads=4)
    assert n_ok == n_ref == 12 and native_decode.routes == {"native": 12, "pil": 0}
    np.testing.assert_array_equal(out, ref)
    # a frame that fails is zero-filled and not counted, as in JAX
    (tmp_path / "bad.png").write_bytes(b"not a png")
    out, n_ok = native_decode.decode_batch([paths[0], tmp_path / "bad.png"], w=60, h=40)
    assert n_ok == 1 and (out[1] == 0).all()


@pytest.mark.parametrize("kind", ["png_16bit", "jpeg_progressive"])
def test_rejected_file_takes_the_pil_route_in_both(kind, tmp_path, rng, jlib):
    if kind == "png_16bit":
        p = tmp_path / "d.png"
        Image.fromarray(rng.integers(0, 65536, (12, 10), dtype=np.uint16)).save(p)
    else:
        p = tmp_path / "prog.jpg"
        Image.fromarray(rng.integers(0, 256, (24, 32), dtype=np.uint8), mode="L").save(
            p, quality=90, progressive=True)
    with Image.open(p) as im:
        pil = np.asarray(im.convert("L"), np.float32) / 255.0
    native_decode.routes.update(native=0, pil=0)
    out = native_decode.decode_gray(p)
    assert native_decode.routes == {"native": 0, "pil": 1}
    np.testing.assert_array_equal(out, pil)
    np.testing.assert_array_equal(jnative.decode_gray(p), pil)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native_decode, "SOURCES", (bad,))
    monkeypatch.setattr(native_decode, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_decode, "_lib", None)
    native_decode.routes.update(native=0, pil=0)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        native_decode.decode_gray(tmp_path / "any.png")
    assert native_decode.routes == {"native": 0, "pil": 0}  # not turned into PIL
    assert not list((tmp_path / "build").glob("*"))  # no partial library left


_BUILD_CHILD = r"""
import sys
from pathlib import Path
from visualodometry_tpu_torch.data import native_decode as nd
nd.BUILD_DIR = Path(sys.argv[1])
lib = nd.get_lib()
print(nd.image_info(sys.argv[2]))
"""


def test_concurrent_builds_all_succeed(tmp_path, rng):
    """Three processes build the library into one empty directory at once."""
    img = tmp_path / "g.png"
    _write(img, rng.integers(0, 256, (7, 9), dtype=np.uint8), "L")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [
        subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(tmp_path / "build"), str(img)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(3)
    ]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "(9, 7)"
    assert [f.suffix for f in (tmp_path / "build").iterdir()] == [".so"]


# ---- prefetch ---------------------------------------------------------------

def test_prefetch_order_and_content(tmp_path, rng):
    paths = []
    for i in range(9):
        p = tmp_path / f"{i}.png"
        _write(p, rng.integers(0, 256, (8, 12), dtype=np.uint8), "L")
        paths.append(p)
    got = list(prefetch.PrefetchLoader(paths, depth=2))
    assert len(got) == 9
    for p, g in zip(paths, got):
        np.testing.assert_array_equal(g, jnative.decode_gray(p))
    # with PIL as the decoder, the JAX loader's frames
    a = list(prefetch.PrefetchLoader(paths, depth=3, decode=prefetch.decode_grayscale))
    from visualodometry_tpu.data.prefetch import PrefetchLoader as JLoader
    from visualodometry_tpu.data.prefetch import decode_grayscale as jdecode

    b = list(JLoader(paths, depth=3, decode=jdecode))
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y)


def _workers():
    return [t for t in threading.enumerate() if t.name == "prefetch-worker"]


@pytest.mark.parametrize("depth", [1, 4])
def test_prefetch_worker_stops_on_early_break(depth):
    decoded = []

    def decode(i):
        decoded.append(i)
        return np.full((2, 2), i, np.float32)

    before = len(_workers())
    for x in prefetch.PrefetchLoader(range(1000), depth=depth, decode=decode):
        if x[0, 0] == 2:
            break
    deadline = time.monotonic() + 5.0
    while len(_workers()) > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(_workers()) == before, "the worker outlived the consumer"
    assert len(decoded) <= 3 + depth + 1  # it stopped decoding ahead


def test_prefetch_raises_a_decode_error():
    def decode(i):
        if i == 3:
            raise OSError("unreadable frame 3")
        return np.zeros((1, 1), np.float32)

    got = []
    with pytest.raises(OSError, match="frame 3"):
        for x in prefetch.PrefetchLoader(range(6), depth=2, decode=decode):
            got.append(x)
    assert len(got) == 3


# ---- the photo texture ------------------------------------------------------

def test_photo_texture_equals_jax():
    scene_t = synthetic.make_scene(np.random.default_rng(3), num_frames=2,
                                   image_size=(160, 64), num_landmarks=2)
    scene_j = jsyn.make_scene(np.random.default_rng(3), num_frames=2,
                              image_size=(160, 64), num_landmarks=2)
    assert synthetic._photo_mosaic(0) is not None, "matplotlib's sample photo is missing"
    for f in range(2):
        a, da = synthetic.render_textured_image(scene_t, f, with_depth=True, texture="photo")
        b, db = jsyn.render_textured_image(scene_j, f, with_depth=True, texture="photo")
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(da, db)
        noise = synthetic.render_textured_image(scene_t, f)
        assert np.abs(a - noise).max() > 0.1  # another texture than value noise


def test_photo_texture_without_matplotlib_is_value_noise(monkeypatch):
    scene = synthetic.make_scene(np.random.default_rng(3), num_frames=1,
                                 image_size=(96, 48), num_landmarks=2)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    synthetic._photo_mosaic.cache_clear()
    try:
        photo = synthetic.render_textured_image(scene, 0, texture="photo")
    finally:
        synthetic._photo_mosaic.cache_clear()
    np.testing.assert_array_equal(photo, synthetic.render_textured_image(scene, 0))
