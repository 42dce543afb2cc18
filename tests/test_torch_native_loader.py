"""The port's native JPEG loader against the JAX package's on the same blobs.

Both build the same C++ source (the port from its own byte-for-byte copy)
against the system libjpeg; the port's library goes to
build/rlaifv_tpu_torch/, never into the package. Outputs are compared byte
for byte, for a threaded batch of mixed sizes and for a batch holding a
PNG, which takes the PIL path in both; a library that fails to load
sends the port's loader down the PIL path.
"""
import io

import numpy as np
import pytest

from rlaifv_tpu.data import native_loader as jax_loader
from rlaifv_tpu_torch.data import native_loader as port_loader

ROOT = port_loader.BUILD_DIR.parents[1]


def _blob(rng, w, h, fmt="JPEG"):
    from PIL import Image

    arr = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def test_port_loader_builds_into_build_dir():
    assert port_loader.native_available(), "the C++ loader failed to build"
    so = port_loader.library_path()
    assert so.exists() and so.parent == ROOT / "build" / "rlaifv_tpu_torch"
    package = ROOT / "rlaifv_tpu_torch" / "native"
    assert sorted(p.name for p in package.iterdir()) == ["image_loader.cpp"]


def test_jpeg_dims_match():
    rng = np.random.default_rng(0)
    for w, h in ((123, 77), (64, 64), (9, 301)):
        blob = _blob(rng, w, h)
        assert port_loader.jpeg_dims(blob) == jax_loader.jpeg_dims(blob) == (w, h)
    assert port_loader.jpeg_dims(b"not a jpeg") is None


@pytest.mark.parametrize("threads", [1, 8])
def test_batch_byte_equal_to_the_jax_loader(threads):
    rng = np.random.default_rng(2)
    blobs = [_blob(rng, int(w), int(h)) for w, h in rng.integers(20, 300, size=(12, 2))]
    got = port_loader.NativeImageLoader(num_threads=threads)(blobs)
    want = jax_loader.NativeImageLoader(num_threads=threads)(blobs)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape[0] == g.shape[1]
        np.testing.assert_array_equal(g, w)
    # the native path decodes as PIL does (both libjpeg), padded the same way
    loader = port_loader.NativeImageLoader()
    for g, f in zip(got, loader._fallback(blobs)):
        np.testing.assert_array_equal(g, f)


def test_png_in_the_batch_takes_the_pil_path_in_both(monkeypatch):
    rng = np.random.default_rng(3)
    blobs = [_blob(rng, 50, 60), _blob(rng, 40, 30, fmt="PNG"), _blob(rng, 33, 33)]
    calls = []
    orig = port_loader.NativeImageLoader._fallback
    monkeypatch.setattr(port_loader.NativeImageLoader, "_fallback",
                        lambda self, b: calls.append(len(b)) or orig(self, b))
    got = port_loader.NativeImageLoader(background=(1, 2, 3))(blobs)
    want = jax_loader.NativeImageLoader(background=(1, 2, 3))(blobs)
    assert calls == [3]  # the whole batch, as in the JAX loader
    assert [g.shape for g in got] == [(60, 60, 3), (40, 40, 3), (33, 33, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1][0, 0] == (1, 2, 3)).all()


def test_a_library_that_does_not_load_means_the_pil_path(monkeypatch):
    """A library built on another machine may miss this one's libjpeg: the
    OSError of loading it sends every batch down the PIL path, where the
    JAX loader would raise."""
    import ctypes

    def missing(path):
        raise OSError("libjpeg.so.62: cannot open shared object file")

    monkeypatch.setattr(port_loader, "_lib", None)
    monkeypatch.setattr(port_loader, "_build_failed", False)
    monkeypatch.setattr(ctypes, "CDLL", missing)
    assert not port_loader.native_available()
    assert port_loader.jpeg_dims(_blob(np.random.default_rng(4), 30, 20)) is None
    blob = _blob(np.random.default_rng(5), 30, 20)
    out = port_loader.NativeImageLoader()([blob])[0]
    np.testing.assert_array_equal(out, port_loader.NativeImageLoader()._fallback([blob])[0])
