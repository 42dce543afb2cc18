"""The port's DeviceImagePipeline (on the CPU here) against the JAX
package's on the same uint8 images, and against the host
ClipImageProcessor.

Both resample by the same PIL-faithful weight matrices in fp32 and round
to uint8 after each pass; the two products sum in another order, so a
pre-rounding value within float rounding of a half-integer (a tie) may
round the other way. Away from ties the outputs agree within 1e-5 after
the normalisation; at a tie they differ by one uint8 step, never more.
"""
import numpy as np
import pytest
import torch

from rlaifv_tpu.ops.image_kernels import DeviceImagePipeline as JaxPipeline
from rlaifv_tpu_torch.data.image_processing import ClipImageProcessor
from rlaifv_tpu_torch.ops.image_kernels import DeviceImagePipeline, pil_resize_weights

TIE_EPS = 1e-3  # a float64 pre-rounding value this close to k + 0.5 is a tie
STEP = 1.0 / 255.0


def _images(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=(*s, 3), dtype=np.uint8) for s in shapes]


def _near_half(x):
    return np.abs(x - np.floor(x) - 0.5) < TIE_EPS


def _tie_mask(img, D):
    """(D, D, 3) bool: output pixels one of whose roundings (the vertical
    pass's own, or a horizontal one it reads) is a tie, from float64 passes
    of the square-padded `img`."""
    S = img.shape[0]
    W = pil_resize_weights(S, D).astype(np.float64)
    h = np.einsum("dw,hwc->hdc", W, img.astype(np.float64))
    h_tie = _near_half(h)
    v = np.einsum("ds,swc->dwc", W, np.clip(np.round(h), 0, 255))
    reads = (W != 0).astype(np.float64)
    return _near_half(v) | (np.einsum("ds,swc->dwc", reads, h_tie.astype(np.float64)) > 0)


def _pad(pipe, img):
    return pipe._pad_square_host(img)


@pytest.mark.parametrize("D,shapes", [
    (336, [(448, 448), (640, 480), (100, 260), (336, 336), (448, 448), (200, 120)]),
    (28, [(40, 40), (17, 30), (28, 28), (9, 9)]),
])
def test_matches_the_jax_pipeline(D, shapes):
    imgs = _images(0, shapes)
    pipe = DeviceImagePipeline(image_size=D, device="cpu")
    got = pipe(imgs)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(imgs), D, D, 3)
    got = got.numpy()
    want = np.asarray(JaxPipeline(image_size=D)(imgs))
    std = np.asarray(pipe.std.numpy(), np.float32)
    steps = np.abs(got - want) * std / STEP  # uint8 steps a pixel
    ties = np.stack([_tie_mask(_pad(pipe, im), D) for im in imgs])
    off = ~ties
    assert np.abs(got - want)[off].max() <= 1e-5
    assert steps.max() <= 1 + 1e-3
    n_tie_diff = int((np.abs(got - want) > 1e-5).sum())
    # the pixels that differ are tie pixels; state their count
    assert n_tie_diff <= int(ties.sum()), (n_tie_diff, int(ties.sum()))
    print(f"D {D}: {n_tie_diff} of {got.size} values differ by one uint8 step, "
          f"{int(ties.sum())} tie pixels")


@pytest.mark.parametrize("shape", [(448, 448), (640, 480), (100, 260), (336, 336)])
def test_within_two_steps_of_the_host_processor(shape):
    img = _images(0, [shape])[0]
    host = ClipImageProcessor(image_size=336)
    want = host(img)
    got = DeviceImagePipeline(image_size=336, device="cpu")([img])[0].numpy()
    # PIL uses fixed-point int16 coefficients; allow 2 uint8 LSBs
    std = np.asarray(host.std, np.float32)
    assert (np.abs(got - want) * std * 255.0).max() <= 2.0


def test_groups_by_source_size_and_caches_weights():
    imgs = _images(1, [(336, 336), (448, 448), (448, 448), (512, 512), (300, 448)])
    pipe = DeviceImagePipeline(image_size=336, device="cpu")
    out = pipe(imgs)
    assert tuple(out.shape) == (5, 336, 336, 3) and torch.isfinite(out).all()
    assert sorted(pipe._weights) == [(336, 336), (448, 336), (512, 336)]
    for i, im in enumerate(imgs):  # each row as computed alone
        torch.testing.assert_close(out[i], pipe([im])[0], rtol=0, atol=0)


def test_tf32_is_off_inside_the_call_and_restored(monkeypatch):
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        DeviceImagePipeline(image_size=28, device="cpu")(_images(2, [(40, 40)]))
        assert seen == [False, False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
