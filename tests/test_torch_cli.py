"""The port's CLIs (python -m nle_tpu_torch.cli.enhance|denoise|apply)
against nle_tpu's on the CPU: the contract cases of tests/test_cli.py run
through both packages with the same argv (nle_tpu with --platform=cpu, the
port with --device=cpu), their exit codes, stderr messages and stdout
lines compared; the output images of both held to >= 45 dB; and what only
the port's side can show (a filter saved by nle_tpu applied by the port,
the --device flag)."""

import logging
import os

import numpy as np
import pytest

from nle_tpu.cli import apply as japply
from nle_tpu.cli import denoise as jdenoise
from nle_tpu.cli import enhance as jenhance
from nle_tpu.cli.common import add_common_flags as jax_flag_doc
from nle_tpu_torch.cli import apply as tapply
from nle_tpu_torch.cli import denoise as tdenoise
from nle_tpu_torch.cli import enhance as tenhance
from nle_tpu_torch.cli.common import add_common_flags as port_flag_doc
from nle_tpu_torch.utils import imageio
from nle_tpu_torch.utils.imageio import (
    imdecode_bgr,
    imencode_png,
    imread_bgr,
    imwrite_bgr,
)

CLIS = {"enhance": (jenhance.main, tenhance.main),
        "denoise": (jdenoise.main, tdenoise.main),
        "apply": (japply.main, tapply.main)}
PLATFORM = {"jax": "--platform=cpu", "port": "--device=cpu"}


@pytest.fixture(autouse=True)
def quiet_loggers():
    """The libraries' warnings (truncation, rank) go to stderr through
    logging's last-resort handler, and each package dedups them per
    process: keep stderr to what the CLIs print themselves."""
    names = ("nle_tpu", "nle_tpu_torch")
    levels = [logging.getLogger(n).level for n in names]
    for n in names:
        logging.getLogger(n).setLevel(logging.ERROR)
    yield
    for n, lv in zip(names, levels):
        logging.getLogger(n).setLevel(lv)


@pytest.fixture()
def small_image(tmp_path, rng):
    img = rng.integers(0, 256, (20, 24, 3), np.uint8)
    path = str(tmp_path / "in.png")
    imwrite_bgr(path, img)
    return path, img


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _strip_doc(err: str, doc: str) -> list[str]:
    return [line for line in err.replace(doc, "").splitlines() if line]


def run_both(capsys, cli, argv):
    """Run one CLI of each package; `argv` is a list, or a function of
    the package tag ("jax"/"port") for per-package paths. Returns {tag:
    (rc, stdout lines, stderr lines without the flag doc)}."""
    out = {}
    for tag, main, doc in (("jax", CLIS[cli][0], jax_flag_doc()),
                           ("port", CLIS[cli][1], port_flag_doc())):
        args = argv(tag) if callable(argv) else list(argv)
        capsys.readouterr()
        rc = main(args + [PLATFORM[tag]])
        cap = capsys.readouterr()
        out[tag] = (rc, cap.out.splitlines(), _strip_doc(cap.err, doc))
    return out


def _same(res):
    assert res["port"] == res["jax"], (res["port"], res["jax"])
    return res["port"]


# -- messages and exit codes: identical in both packages -----------------------

def _e(path, *rest):
    return [path, "/tmp/x.png", "3", "4", "100", "30", "5", "5", *rest]


CONTRACT = {
    "enhance usage": ("enhance", lambda p: ["a", "b", "1"], "Usage:"),
    "denoise usage": ("denoise", lambda p: ["a"] * 5, "Usage:"),
    "apply usage": ("apply", lambda p: [], "Usage"),
    "enhance missing file": (
        "enhance", lambda p: ["/nonexistent.png", "/tmp/x.png", "3", "4",
                              "100", "30", "5", "5", "1", "2"],
        "Failed to read file from /nonexistent.png"),
    "denoise missing file": (
        "denoise", lambda p: ["/nonexistent.png", "/tmp/x.png", "3", "4",
                              "100", "30", "5", "5", "10", "10", "2"],
        "Failed to read file from /nonexistent.png"),
    "apply missing filter": (
        "apply", lambda p: ["/nope.npz", p, "/tmp/o.png", "1"],
        "Failed to read filter from /nope.npz"),
    "unknown flag": ("enhance", lambda p: _e(p, "1", "2", "--no-palas"),
                     "Unknown flag --no-palas"),
    "valueless save-filter": ("enhance",
                              lambda p: _e(p, "1", "2", "--save-filter"),
                              "Flag --save-filter requires a value"),
    "bad positional": ("enhance", lambda p: _e(p, "1", "out.npz"),
                       "Bad argument: could not convert string to float"),
    "stage1 requires a value": ("enhance",
                                lambda p: _e(p, "1", "2", "--stage1"),
                                "Flag --stage1 requires a value"),
    "bad stage1": ("enhance", lambda p: _e(p, "1", "2", "--stage1=hots64"),
                   "Flag --stage1=hots64 invalid"),
    "bad precision": ("denoise",
                      lambda p: _e(p, "10", "10", "2", "--precision=f99"),
                      "Flag --precision=f99 invalid"),
    "valued bool flag": ("enhance",
                         lambda p: _e(p, "1", "2", "--factored=yes"),
                         "Flag --factored takes no value"),
    "bad reuse-delta": ("enhance",
                        lambda p: _e(p, "1", "2", "--reuse-delta=-1"),
                        "Flag --reuse-delta=-1 invalid"),
    "apply bad op": ("apply", lambda p: ["f.npz", p, "/tmp/o.png", "1",
                                         "--op=sharpen"], "invalid"),
    "apply shrink without denoise": (
        "apply", lambda p: ["f.npz", p, "/tmp/o.png", "1", "--shrink=3"],
        "--op=denoise"),
    "apply valueless shrink": (
        "apply", lambda p: ["f.npz", p, "/tmp/o.png", "--op=denoise",
                            "--shrink"], "requires a number"),
}


@pytest.mark.parametrize("case", sorted(CONTRACT))
def test_contract_messages_match_nle_tpu(case, capsys, small_image):
    cli, argv, needle = CONTRACT[case]
    rc, out, err = _same(run_both(capsys, cli, argv(small_image[0])))
    assert rc == 0
    assert any(needle in line for line in err), err
    assert out == []


def test_device_flag_is_validated(capsys, small_image):
    """--device takes cuda|cpu (nle_tpu's --platform takes the JAX names);
    a bad value gets the other flags' message form, before any work."""
    path, _ = small_image
    for main in (tenhance.main, tdenoise.main):
        assert main(_e(path, "10", "10", "2", "--device=tpu")) == 0
        err = capsys.readouterr().err
        assert "Flag --device=tpu invalid (expected cuda|cpu)" in err
        assert "Usage:" in err


def test_cuda_without_a_card_raises(small_image, tmp_path):
    """The default device is the card, with no fallback to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path, _ = small_image
    with pytest.raises(RuntimeError, match="cuda"):
        tenhance.main(_e(path, "1", "2")[:1] + [str(tmp_path / "o.png")]
                      + _e(path, "1", "2")[2:])


# -- end to end: the same contract, and the images >= 45 dB -------------------

def test_enhance_end_to_end(tmp_path, small_image, capsys):
    path, img = small_image

    def argv(tag):
        return [path, str(tmp_path / f"{tag}.png"), "3", "4", "100", "30",
                "5", "5", "2", "3", "4", "1",
                f"--save-filter={tmp_path / tag}.npz"]

    rc, out, err = _same(run_both(capsys, "enhance", argv))
    assert rc == 0 and out == ["Done."] and err == []
    a, b = imread_bgr(str(tmp_path / "jax.png")), imread_bgr(
        str(tmp_path / "port.png"))
    assert a.shape == img.shape
    db = _psnr(a, b)
    print(f"nle-enhance, port vs nle_tpu: {db:.2f} dB")
    assert db >= 45.0
    assert os.path.exists(tmp_path / "port.npz")


@pytest.mark.parametrize("factored", [False, True])
def test_denoise_end_to_end(tmp_path, small_image, capsys, factored):
    """The eig lines: one per kept eigenvector, clamped at 1, in %.6g of
    the float64 S; the values agree to 1e-3 (the two packages' float32
    routes sum in other orders)."""
    path, img = small_image
    extra = ["--factored"] if factored else []

    def argv(tag):
        return [path, str(tmp_path / f"{tag}.png"), "3", "4", "200", "30",
                "5", "5", "10", "10", "2", *extra]

    res = run_both(capsys, "denoise", argv)
    (rj, oj, ej), (rt, ot, et) = res["jax"], res["port"]
    assert rj == rt == 0 and ej == et == []
    assert len(ot) == len(oj) == 6 and ot[-1] == oj[-1] == "Done."
    for lj, lt in zip(oj[:-1], ot[:-1]):
        hj, vj = lj.rsplit(" ", 1)
        ht, vt = lt.rsplit(" ", 1)
        assert hj == ht and ht.startswith("eig ") and ht.endswith(" val:")
        assert float(vt) <= 1.0
        np.testing.assert_allclose(float(vt), float(vj), rtol=1e-3)
    db = _psnr(imread_bgr(str(tmp_path / "jax.png")),
               imread_bgr(str(tmp_path / "port.png")))
    print(f"nle-denoise factored={factored}, port vs nle_tpu: {db:.2f} dB")
    assert db >= 45.0


@pytest.mark.parametrize("flag", ["--stage1=topk", "--stage1=device",
                                  "--precision=float64", "--no-pallas",
                                  "--factored", "--eps=1e-8"])
def test_enhance_options_end_to_end(tmp_path, small_image, capsys, flag):
    path, _ = small_image

    def argv(tag):
        return [path, str(tmp_path / f"{tag}.png"), "3", "4", "100", "30",
                "5", "5", "1", "2", flag]

    rc, out, err = _same(run_both(capsys, "enhance", argv))
    assert rc == 0 and out == ["Done."]
    db = _psnr(imread_bgr(str(tmp_path / "jax.png")),
               imread_bgr(str(tmp_path / "port.png")))
    print(f"nle-enhance {flag}, port vs nle_tpu: {db:.2f} dB")
    assert db >= 45.0


def test_show_done_line(tmp_path, small_image, capsys, monkeypatch):
    """Under --show the reference's exact stdout line, and the headless
    note on stderr; headless runs print "Done."."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.setattr("sys.platform", "linux")
    path, _ = small_image

    def argv(tag):
        return [path, str(tmp_path / f"{tag}.png"), "3", "4", "100", "30",
                "5", "5", "2", "3", "--show"]

    rc, out, err = _same(run_both(capsys, "enhance", argv))
    assert out == ["Done. Press any key in result window to exit."]
    assert err == ["--show: no display available; the output was written "
                   "to disk."]
    assert os.path.exists(tmp_path / "port.png")


def test_debug_eigvecs_files(tmp_path, small_image, capsys):
    path, _ = small_image

    def argv(tag):
        return [path, str(tmp_path / f"{tag}.png"), "3", "4", "100", "30",
                "5", "5", "2", "3", f"--debug-eigvecs={tmp_path / tag}"]

    res = run_both(capsys, "enhance", argv)
    for tag in ("jax", "port"):
        rc, out, err = res[tag]
        assert rc == 0 and out == ["Done."]
        assert [e.split(" eigval")[0] for e in err] == [
            f"Eigvec {i}" for i in range(5)]
        assert sorted(os.listdir(tmp_path / tag)) == [
            f"eigvec_{i}.png" for i in range(5)]
    for i in range(5):
        a = imread_bgr(str(tmp_path / "jax" / f"eigvec_{i}.png"))
        b = imread_bgr(str(tmp_path / "port" / f"eigvec_{i}.png"))
        assert a.shape == b.shape == (20, 24, 3)
    # the factored filter has no eigenvector matrix: a note, no files
    rc, out, err = _same(run_both(capsys, "enhance", lambda tag: argv(
        tag + "_f") + ["--factored"]))
    assert rc == 0 and err == ["--debug-eigvecs: factored filters store no "
                               "eigenvector matrix; skipping dumps."]


@pytest.mark.parametrize("op", ["enhance", "denoise"])
def test_apply_matches_direct_run(tmp_path, small_image, capsys, op):
    """nle-apply with the saved filter gives the direct run's image bit
    for bit in the port (as tests/test_cli.py asserts for nle_tpu), both
    packages print the same lines, and --op=denoise takes no weights."""
    path, _ = small_image
    train = tenhance.main if op == "enhance" else tdenoise.main
    tail = (["2", "3", "4", "1"] if op == "enhance"
            else ["10", "10", "2"])
    fpath = str(tmp_path / "f.npz")
    assert train([path, str(tmp_path / "direct.png"), "4", "5", "50", "30",
                  "5", "4", *tail, f"--save-filter={fpath}",
                  "--device=cpu"]) == 0
    args = (["2", "3", "4", "1"] if op == "enhance"
            else ["--op=denoise", "--shrink=2"])

    def argv(tag):
        return [fpath, path, str(tmp_path / f"{tag}.png"), *args]

    rc, out, err = _same(run_both(capsys, "apply", argv))
    assert rc == 0 and out == ["Done."] and err == []
    np.testing.assert_array_equal(imread_bgr(str(tmp_path / "port.png")),
                                  imread_bgr(str(tmp_path / "direct.png")))
    assert _psnr(imread_bgr(str(tmp_path / "port.png")),
                 imread_bgr(str(tmp_path / "jax.png"))) >= 45.0
    if op == "denoise":
        rc, out, err = _same(run_both(capsys, "apply", lambda tag: argv(
            tag)[:3] + ["5", "9", "--op=denoise"]))
        assert err == ["nle-apply: --op=denoise ignores the weight "
                       "positionals 5 9"]


def test_apply_denoise_sigma_flags(tmp_path, small_image, capsys):
    """nle-apply --op=denoise with its own bilateral sigmas: the same lines
    as nle_tpu's, the images >= 45 dB, and the sigmas change the output."""
    path, _ = small_image
    fpath = str(tmp_path / "f.npz")
    assert tdenoise.main([path, str(tmp_path / "d.png"), "4", "5", "50",
                          "30", "5", "4", "10", "10", "2",
                          f"--save-filter={fpath}", "--device=cpu"]) == 0

    def argv(tag):
        return [fpath, path, str(tmp_path / f"{tag}.png"), "--op=denoise",
                "--shrink=1.5", "--sigma-color=7.5", "--sigma-space=3"]

    rc, out, err = _same(run_both(capsys, "apply", argv))
    assert rc == 0 and out == ["Done."] and err == []
    got = imread_bgr(str(tmp_path / "port.png"))
    assert _psnr(got, imread_bgr(str(tmp_path / "jax.png"))) >= 45.0
    assert not np.array_equal(got, imread_bgr(str(tmp_path / "d.png")))


def test_profile_writes_a_trace(tmp_path, small_image):
    path, _ = small_image
    prof = tmp_path / "prof"
    assert tenhance.main([path, str(tmp_path / "o.png"), "3", "4", "100",
                          "30", "5", "5", "1", "2", f"--profile={prof}",
                          "--device=cpu"]) == 0
    assert (prof / "trace.json").stat().st_size > 0


def test_check_nans_raises_on_a_nan_stage_output(tmp_path, small_image,
                                                 monkeypatch):
    """--check-nans (nle_tpu's jax_debug_nans): a NaN in a stage output
    raises FloatingPointError; without the flag the run goes on."""
    import torch

    from nle_tpu_torch.config import set_check_nans
    from nle_tpu_torch.ops import pipeline as tpipe

    path, _ = small_image
    argv = [path, str(tmp_path / "o.png"), "3", "4", "100", "30", "5", "5",
            "1", "2", "--device=cpu"]
    try:
        assert tenhance.main(argv + ["--check-nans"]) == 0
        real = tpipe.transform_eigenvalues
        monkeypatch.setattr(tpipe, "transform_eigenvalues",
                            lambda S, w: real(S, w) * torch.nan)
        with pytest.raises(FloatingPointError, match="NaN in the edit"):
            tenhance.main(argv + ["--check-nans"])
        assert tenhance.main(argv) == 0
    finally:
        set_check_nans(False)


def test_apply_warns_on_training_only_flags(tmp_path, small_image, capsys):
    path, _ = small_image
    fpath = str(tmp_path / "f.npz")
    assert tenhance.main([path, str(tmp_path / "o.png"), "4", "5", "100",
                          "30", "5", "4", "1", "2", f"--save-filter={fpath}",
                          "--device=cpu"]) == 0

    def argv(tag):
        return [fpath, path, str(tmp_path / f"{tag}.png"), "1", "2",
                f"--save-filter={tmp_path / tag}_re.npz", "--no-pallas"]

    rc, out, err = _same(run_both(capsys, "apply", argv))
    assert err == ["nle-apply: ignoring flag(s) not applicable here: "
                   "--no-pallas, --save-filter"]
    assert out == ["Done."] and not os.path.exists(tmp_path / "port_re.npz")


def test_suffixless_save_filter(tmp_path, small_image, capsys):
    """np.savez appends .npz; nle-apply finds the file from the name the
    user gave."""
    path, _ = small_image

    def argv(tag):
        return [path, str(tmp_path / f"{tag}.png"), "3", "4", "100", "30",
                "5", "5", "1", "2", f"--save-filter={tmp_path / tag}"]

    _same(run_both(capsys, "enhance", argv))
    assert os.path.exists(tmp_path / "port.npz")
    rc, out, err = _same(run_both(capsys, "apply", lambda tag: [
        str(tmp_path / tag), path, str(tmp_path / f"{tag}_a.png"), "1",
        "2"]))
    assert rc == 0 and out == ["Done."]
    np.testing.assert_array_equal(imread_bgr(str(tmp_path / "port_a.png")),
                                  imread_bgr(str(tmp_path / "port.png")))


def test_apply_size_mismatch_message(tmp_path, small_image, capsys, rng):
    path, _ = small_image
    fpath = str(tmp_path / "f.npz")
    assert tenhance.main([path, str(tmp_path / "o.png"), "3", "4", "100",
                          "30", "5", "5", "1", "2", f"--save-filter={fpath}",
                          "--device=cpu"]) == 0
    other = str(tmp_path / "big.png")
    imwrite_bgr(other, rng.integers(0, 256, (30, 30, 3), np.uint8))
    rc, out, err = _same(run_both(capsys, "apply", lambda tag: [
        fpath, other, str(tmp_path / "o3.png"), "1", "2"]))
    assert rc == 0 and out == []
    assert err == ["Cannot apply filter on image with different size from "
                   "the image filter was trained on."]


@pytest.mark.parametrize("factored", [False, True])
def test_filter_saved_by_nle_tpu_applies_in_the_port(tmp_path, small_image,
                                                     capsys, factored):
    """nle-enhance of nle_tpu saves; the port's nle-apply edits with that
    file (the factored kind detected from it) within 1 LSB of nle_tpu's
    nle-apply on it."""
    path, _ = small_image
    fpath = str(tmp_path / "jax_filter.npz")
    extra = ["--factored"] if factored else []
    assert jenhance.main([path, str(tmp_path / "o.png"), "4", "5", "100",
                          "30", "5", "4", "2", "3", f"--save-filter={fpath}",
                          "--platform=cpu", *extra]) == 0
    rc, out, err = _same(run_both(capsys, "apply", lambda tag: [
        fpath, path, str(tmp_path / f"{tag}.png"), "2", "3"]))
    assert rc == 0 and out == ["Done."]
    a = imread_bgr(str(tmp_path / "jax.png")).astype(np.int32)
    b = imread_bgr(str(tmp_path / "port.png")).astype(np.int32)
    assert _psnr(a, b) >= 45.0


def _run_one(capsys, cli, argv, tag):
    """(rc, first stderr line) of one package's CLI on argv."""
    main, doc = ((CLIS[cli][0], jax_flag_doc()) if tag == "jax"
                 else (CLIS[cli][1], port_flag_doc()))
    capsys.readouterr()
    rc = main(list(argv) + [PLATFORM[tag]])
    err = _strip_doc(capsys.readouterr().err, doc)
    return rc, err[:1]


def test_cli_fuzz_matches_nle_tpu(tmp_path, small_image, capsys):
    """Randomized malformed argv across the three CLIs (tests/test_cli.py's
    draws): each draw gives both packages the same exit code and the same
    first stderr line, or the same exception type with the same message."""
    path, _ = small_image
    out = str(tmp_path / "o.png")
    rng = np.random.default_rng(11)
    pieces = [path, out, "/nonexistent.png", "", "2", "3", "-1", "0",
              "abc", "1e3", "30.5", "--no-pallas", "--precision=float99",
              "--eps=", "--eps=xyz", "--stage1=bogus", "--save-filter",
              "--unknown-flag", "--factored", "--debug-eigvecs", "-",
              "999999999999999999999", "nan"]
    names = sorted(CLIS)
    for _ in range(50):
        n = int(rng.integers(0, 8))
        argv = [pieces[int(rng.integers(len(pieces)))] for _ in range(n)]
        cli = names[int(rng.integers(len(names)))]
        res = {}
        for tag in ("jax", "port"):
            try:
                res[tag] = _run_one(capsys, cli, argv, tag)
            except Exception as e:     # a guard's ValueError, as nle_tpu's
                res[tag] = (type(e).__name__, str(e))
                capsys.readouterr()
        assert res["port"] == res["jax"], (cli, argv, res)


# -- the port's own image I/O -------------------------------------------------

@pytest.mark.parametrize("backend", ["opencv", "pillow"])
def test_imageio_round_trip_and_error_contract(tmp_path, rng, monkeypatch,
                                               backend):
    """Both backends: a PNG written reads back bit for bit and as nle_tpu's
    imageio reads it; an unreadable file raises FileNotFoundError (the
    CLIs' "Failed to read file" message), undecodable bytes ValueError."""
    from nle_tpu.utils.imageio import imread_bgr as jax_imread

    monkeypatch.setattr(imageio, "_HAVE_CV2", backend == "opencv")
    img = rng.integers(0, 256, (37, 53, 3), np.uint8)
    path = str(tmp_path / "x.png")
    imwrite_bgr(path, img)
    np.testing.assert_array_equal(imread_bgr(path), img)
    np.testing.assert_array_equal(jax_imread(path), img)
    np.testing.assert_array_equal(imdecode_bgr(imencode_png(img)), img)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    for p in (str(tmp_path / "missing.png"), str(bad)):
        with pytest.raises(FileNotFoundError):
            imread_bgr(p)
    for data in (b"", b"not an image"):
        with pytest.raises(ValueError):
            imdecode_bgr(data)
