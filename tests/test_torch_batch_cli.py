"""The port's batch CLI (python -m nle_tpu_torch.cli.batch) against
nle_tpu's (nle_tpu.cli.batch) on the CPU: one argv through both packages
(nle_tpu with --platform=cpu, the port with --device=cpu), their exit
codes, stdout and stderr compared (the flag docs aside, which name each
package's device flag); the output images of both held to >= 45 dB; and
each port output bitwise the port's own per-image CLI (cli.enhance /
cli.denoise) on the same image."""

import logging
import os

import numpy as np
import pytest

from nle_tpu.cli import batch as jbatch
from nle_tpu.cli.common import add_common_flags as jax_flag_doc
from nle_tpu_torch.cli import batch as tbatch
from nle_tpu_torch.cli import denoise as tdenoise
from nle_tpu_torch.cli import enhance as tenhance
from nle_tpu_torch.cli.common import add_common_flags as port_flag_doc
from nle_tpu_torch.utils.imageio import imread_bgr, imwrite_bgr

PSNR_DB = 45.0    # the two packages' outputs on one argv
TRAIN = ["3", "4", "100", "30", "5", "4"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The batch CLI runs edits on a 4-thread pool: cap torch's CPU threads
    so that a parallel test run is not oversubscribed."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def quiet_loggers():
    """Keep stderr to what the CLIs print themselves (each package's
    library warnings go through logging, deduplicated per process)."""
    names = ("nle_tpu", "nle_tpu_torch")
    levels = [logging.getLogger(n).level for n in names]
    for n in names:
        logging.getLogger(n).setLevel(logging.ERROR)
    yield
    for n, lv in zip(names, levels):
        logging.getLogger(n).setLevel(lv)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def run_both(capsys, argv, out_dir=None):
    """Run nle_tpu's batch CLI, then the port's, on `argv`; the first
    run's output directory is moved to <out_dir>-jax so the second writes
    the same paths (and prints the same lines). Returns {tag: (rc, stdout
    lines, stderr lines without the flag doc)}."""
    res = {}
    for tag, main, flag, doc in (
            ("jax", jbatch.main, "--platform=cpu", jax_flag_doc()),
            ("port", tbatch.main, "--device=cpu", port_flag_doc())):
        capsys.readouterr()
        rc = main(list(argv) + [flag])
        cap = capsys.readouterr()
        res[tag] = (rc, cap.out.splitlines(),
                    [ln for ln in cap.err.replace(doc, "").splitlines()
                     if ln])
        if tag == "jax" and out_dir and os.path.isdir(out_dir):
            os.rename(out_dir, out_dir + "-jax")
    assert res["port"] == res["jax"], (res["port"], res["jax"])
    return res["port"]


def _images(tmp_path, rng, shapes, prefix="in"):
    paths, imgs = [], []
    for i, shape in enumerate(shapes):
        img = rng.integers(0, 256, shape, np.uint8)
        path = str(tmp_path / f"{prefix}{i}.png")
        imwrite_bgr(path, img)
        paths.append(path)
        imgs.append(img)
    return paths, imgs


def test_batch_cli_usage_exit0(capsys):
    rc, out, err = run_both(capsys, ["a"] * 4)
    assert rc == 0 and out == []
    assert any("Usage:" in line for line in err)


def test_batch_cli_matches_enhance(tmp_path, rng, capsys):
    """Mixed shapes grouped, an unreadable input skipped with the
    reference's message; the same lines from both packages; each output
    >= 45 dB from nle_tpu's and bitwise the port's own cli.enhance."""
    paths, imgs = _images(tmp_path, rng,
                          [(16, 20, 3), (16, 20, 3), (12, 14, 3)])
    out_dir = str(tmp_path / "out")
    rc, out, err = run_both(
        capsys, [out_dir, *TRAIN, "2,3,4,1", paths[0], paths[1],
                 "/nonexistent.png", paths[2]], out_dir)
    assert rc == 0 and out == ["Done."]
    assert "Failed to read file from /nonexistent.png" in err
    assert f"2 image(s) at 20x16 -> {out_dir}" in err
    for i, img in enumerate(imgs):
        name = f"in{i}-enhanced.png"
        got = imread_bgr(os.path.join(out_dir, name))
        jax_out = imread_bgr(os.path.join(out_dir + "-jax", name))
        assert got.shape == img.shape
        assert _psnr(got, jax_out) >= PSNR_DB, i
        single = str(tmp_path / f"single{i}.png")
        assert tenhance.main([paths[i], single, *TRAIN, "2", "3", "4", "1",
                              "--device=cpu"]) == 0
        np.testing.assert_array_equal(got, imread_bgr(single))


def test_batch_cli_denoise_matches_single(tmp_path, rng, capsys):
    paths, imgs = _images(tmp_path, rng, [(16, 20, 3)] * 2, prefix="n")
    out_dir = str(tmp_path / "out")
    rc, out, err = run_both(
        capsys, ["--op=denoise", out_dir, *TRAIN, "10,10,2", *paths],
        out_dir)
    assert rc == 0 and out == ["Done."]
    for i, img in enumerate(imgs):
        name = f"n{i}-denoised.png"
        got = imread_bgr(os.path.join(out_dir, name))
        assert _psnr(got, imread_bgr(os.path.join(out_dir + "-jax", name))
                     ) >= PSNR_DB, i
        single = str(tmp_path / f"single{i}.png")
        capsys.readouterr()
        assert tdenoise.main([paths[i], single, *TRAIN, "10", "10", "2",
                              "--device=cpu"]) == 0
        np.testing.assert_array_equal(got, imread_bgr(single))


@pytest.mark.parametrize("argv, needle", [
    (["--op=denoise", "OUT", *TRAIN, "1,2", "IMG"], "Bad argument"),
    (["--op=sharpen", "OUT", *TRAIN, "1,2,3", "IMG"], "--op=sharpen invalid"),
    (["OUT", *TRAIN, "2,x", "IMG"], "Bad argument"),
    (["OUT", *TRAIN, "2,3", "IMG", "--no-palas"], "Unknown flag --no-palas"),
    (["OUT", *TRAIN, "2,3", "IMG", "--reuse-delta=-1"],
     "Flag --reuse-delta=-1 invalid"),
])
def test_batch_cli_argument_errors_match(tmp_path, rng, capsys, argv,
                                         needle):
    (path,), _ = _images(tmp_path, rng, [(16, 20, 3)])
    out_dir = str(tmp_path / "out")
    argv = [out_dir if a == "OUT" else path if a == "IMG" else a
            for a in argv]
    rc, out, err = run_both(capsys, argv)
    assert rc == 0 and out == []
    assert any(needle in line for line in err), err
    assert any("Usage:" in line for line in err)
    assert not os.path.exists(out_dir)


def test_batch_cli_same_stem_inputs_do_not_clobber(tmp_path, rng, capsys):
    d1, d2 = tmp_path / "d1", tmp_path / "d2"
    d1.mkdir(), d2.mkdir()
    imwrite_bgr(str(d1 / "a.png"), rng.integers(0, 256, (16, 20, 3),
                                                 np.uint8))
    imwrite_bgr(str(d2 / "a.png"), rng.integers(0, 256, (16, 20, 3),
                                                 np.uint8))
    out_dir = str(tmp_path / "out")
    rc, out, err = run_both(
        capsys, [out_dir, *TRAIN, "2,3,4,1", str(d1 / "a.png"),
                 str(d2 / "a.png"), "--factored"], out_dir)
    assert rc == 0
    assert any("collision" in line for line in err)
    assert any("ignoring flag(s) not applicable here: --factored" in line
               for line in err)
    got1 = imread_bgr(os.path.join(out_dir, "a-enhanced.png"))
    got2 = imread_bgr(os.path.join(out_dir, "a-enhanced-2.png"))
    assert not np.array_equal(got1, got2)


def test_batch_cli_cuda_without_a_card_raises(tmp_path, rng):
    """The card is the default, with no fallback to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    (path,), _ = _images(tmp_path, rng, [(16, 20, 3)])
    with pytest.raises(RuntimeError, match="cuda"):
        tbatch.main([str(tmp_path / "out"), *TRAIN, "2,3,4,1", path])
