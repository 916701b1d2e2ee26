"""Rendering utilities and metrics."""

import numpy as np
import pytest

from beamforming_lk_tpu.utils import (
    BlockMetrics,
    FpsMeter,
    apply_colormap,
    gaussian_blur,
    jet_lut,
    ocean_lut,
    upscale,
    write_png,
)
from beamforming_lk_tpu.utils.png import read_png_size


def test_luts_shape_and_endpoints():
    for lut in (jet_lut(), ocean_lut()):
        assert lut.shape == (256, 3) and lut.dtype == np.uint8
    # JET: low end blue-ish, high end red-ish, middle green-ish.
    j = jet_lut()
    assert j[0, 2] > j[0, 0] and j[255, 0] > j[255, 2] and j[128, 1] > 200


def test_apply_colormap():
    img = np.arange(16, dtype=np.uint8).reshape(4, 4) * 17
    rgb = apply_colormap(img)
    assert rgb.shape == (4, 4, 3) and rgb.dtype == np.uint8


def test_upscale_preserves_constant_and_interpolates():
    img = np.full((8, 8), 100, np.uint8)
    up = upscale(img, (32, 32))
    assert up.shape == (32, 32) and np.all(up == 100)
    # A step edge becomes a gradient under bilinear.
    img2 = np.zeros((2, 2), np.uint8)
    img2[:, 1] = 200
    up2 = upscale(img2, (2, 8))
    assert up2[0, 0] == 0 and up2[0, -1] == 200
    assert np.any((up2[0] > 10) & (up2[0] < 190))
    # Nearest keeps only the two values.
    upn = upscale(img2, (2, 8), bilinear=False)
    assert set(np.unique(upn)) == {0, 200}


def test_gaussian_blur_smooths_but_preserves_mean():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (16, 16)).astype(np.uint8)
    out = gaussian_blur(img, sigma=2.0)
    assert out.shape == img.shape
    assert abs(float(out.mean()) - float(img.mean())) < 8.0
    assert out.std() < img.std()
    # RGB path
    rgb = np.stack([img] * 3, axis=-1)
    out3 = gaussian_blur(rgb, sigma=1.0)
    assert out3.shape == rgb.shape


def test_png_round_trip_size(tmp_path):
    gray = (np.arange(64, dtype=np.uint8).reshape(8, 8)) * 4
    p1 = str(tmp_path / "g.png")
    write_png(p1, gray)
    assert read_png_size(p1) == (8, 8)
    rgb = apply_colormap(gray)
    p2 = str(tmp_path / "c.png")
    write_png(p2, rgb)
    assert read_png_size(p2) == (8, 8)


def test_metrics():
    m = BlockMetrics(block_size=256, sample_rate=48828.0)
    for _ in range(10):
        m.start_block()
        m.end_block()
    s = m.summary()
    assert s["blocks"] == 10
    assert s["samples_per_s"] > 0
    assert s["latency_p50_ms"] >= 0
    f = FpsMeter()
    f.tick(0.0)
    assert abs(f.tick(0.1) - 10.0) < 1e-6


def test_direction_to_pixel_round_trip():
    """direction_to_pixel inverts the heatmap grid construction."""
    from beamforming_lk_tpu.config import MimoConfig
    from beamforming_lk_tpu.models.mimo import make_mimo_grid
    from beamforming_lk_tpu.utils.overlay import direction_to_pixel

    cfg = MimoConfig(rows=16, columns=16)
    theta, phi = make_mimo_grid(cfg)
    for d in (0, 5, 37, 130, 255):
        r, c = d // 16, d % 16
        row, col = direction_to_pixel(float(theta[d]), float(phi[d]), 16)
        # Skip clamped edge pixels (outside the FOV disc).
        import numpy as np

        if np.hypot(r - 7.5, c - 7.5) > 7.5:
            continue
        assert abs(row - r) < 0.51 and abs(col - c) < 0.51, (d, row, col, r, c)


def test_overlay_draws_markers():
    import numpy as np

    from beamforming_lk_tpu.utils.overlay import overlay_targets

    frame = np.zeros((64, 64, 3), np.uint8)
    targets = [
        {"theta": 0.3, "phi": 0.5, "start": 2.0},
        {"theta": 0.6, "phi": 2.5, "start": 1.0},
    ]
    out = overlay_targets(frame, targets, miso_direction=(0.2, 1.0))
    assert out is frame
    assert (frame == 255).any()          # markers drawn
    assert (frame[..., 0] == 255).sum() > (frame[..., 2] == 255).sum()  # red crosshair present


def test_draw_text_and_age_labels():
    import numpy as np

    from beamforming_lk_tpu.utils.overlay import draw_text, overlay_targets

    frame = np.zeros((64, 64, 3), np.uint8)
    draw_text(frame, 2, 2, "123s", (255, 255, 255))
    assert frame.any()
    # Age labels render when now_block is provided and add pixels beyond
    # the bare square markers.
    base = np.zeros((64, 64, 3), np.uint8)
    tgts = [{"theta": 0.3, "phi": 1.0, "start": 0.0}]
    with_age = overlay_targets(
        np.zeros((64, 64, 3), np.uint8), tgts, now_block=191.0
    )
    without = overlay_targets(np.zeros((64, 64, 3), np.uint8), tgts)
    assert (with_age > 0).sum() > (without > 0).sum()


def test_read_png_round_trip(tmp_path):
    from beamforming_lk_tpu.utils.png import read_png, write_png

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (13, 9, 3), np.uint8)
    gray = rng.integers(0, 256, (7, 5), np.uint8)
    write_png(str(tmp_path / "rgb.png"), rgb)
    write_png(str(tmp_path / "gray.png"), gray)
    np.testing.assert_array_equal(read_png(str(tmp_path / "rgb.png")), rgb)
    np.testing.assert_array_equal(read_png(str(tmp_path / "gray.png")), gray)


def test_read_png_all_filters(tmp_path):
    """Decode rows under every PNG filter type (0/1/2/3/4) and RGBA —
    external logos use whatever their encoder picked."""
    import struct
    import zlib

    from beamforming_lk_tpu.utils.png import read_png

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (5, 4, 4), np.int32)  # RGBA
    h, w, ch = img.shape
    stride = w * ch
    flat = img.reshape(h, stride)

    def paeth(a, b, c):
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)

    raw = bytearray()
    for y, ft in enumerate([0, 1, 2, 3, 4]):
        raw.append(ft)
        up = flat[y - 1] if y > 0 else np.zeros(stride, np.int32)
        for x in range(stride):
            a = flat[y][x - ch] if x >= ch else 0
            b = up[x]
            c = up[x - ch] if x >= ch else 0
            pred = {0: 0, 1: a, 2: b, 3: (a + b) // 2, 4: paeth(a, b, c)}[ft]
            raw.append(int(flat[y][x] - pred) & 0xFF)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path = str(tmp_path / "filt.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(raw))))
        f.write(chunk(b"IEND", b""))
    np.testing.assert_array_equal(read_png(path), img.astype(np.uint8))


@pytest.mark.parametrize("env", [None, "/elsewhere/jax-cache"])
def test_use_compile_cache(monkeypatch, env):
    """The helper points JAX at <checkout>/.jax_cache, unless
    JAX_COMPILATION_CACHE_DIR names a directory (then it sets nothing)."""
    import os

    import jax

    from beamforming_lk_tpu.utils import compile_cache as cc

    before = jax.config.jax_compilation_cache_dir
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    try:
        got = cc.use_compile_cache()
        now = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env is None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == now == os.path.join(repo, ".jax_cache")
    else:
        assert got == env and now == before
