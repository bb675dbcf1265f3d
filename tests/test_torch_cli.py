"""The port's `render` CLI against vpt_tpu's, on the CPU.

Both CLIs render `procedural` at 32x32, 2 spp, with --save-exr; the
default 200^3 grid is swapped in both packages for one 16^3 fBm grid
(the full grid costs seconds per build here).  The EXR radiance must
agree ray for ray (tests/torch_parity.py: share >= 0.99) and the PNGs
within 1 of 255; the port's kill-and-resume is bit-identical to an
uninterrupted run; a checkpoint written by vpt_tpu resumes in the port.
"""

import argparse

import numpy as np
import pytest
from PIL import Image

import vpt_tpu.app.cli as jcli
import vpt_tpu_torch.app.cli as tcli
from torch_parity import radiance_share  # tests/, on sys.path under pytest
from vpt_tpu.utils.exr import read_exr_rgb
from vpt_tpu.volume import procedural as jproc
from vpt_tpu_torch.utils import exr as texr
from vpt_tpu_torch.utils.io import read_png
from vpt_tpu_torch.volume import procedural as tproc

MIN_SHARE = 0.99
COMMON = ["--width", "32", "--height", "32", "--ray-depth", "3", "--cpu",
          "--save-exr"]
# the point light only where it costs no bake: the reference's 240x480
# angular point-light bake takes seconds even on a small grid
CASES = {"tracked_constant": ["--env-type", "constant", "--light", "0", "12",
                              "12", "1", "1", "1", "200"],
         "cached_black": ["--env-type", "black", "--shadow-mode", "cached"],
         # volume_depth 2 and the depth-of-field overlay, with a lens whose
         # focus band cuts through the volume
         "vd2_dof": ["--env-type", "black", "--shadow-mode", "cached",
                     "--volume-depth", "2", "--aov", "dof", "--aperture",
                     "0.5"]}


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """Every render the tests below compare, made once: {name: path stem}."""
    d = tmp_path_factory.mktemp("cli")
    # the port's fill (the reference's costs a jit compile): the same
    # numpy HostGrid fields feed both builders
    grid = tproc.create_procedural_grid(vmin=(-8.0,) * 3, vmax=(8.0,) * 3,
                                        scale=0.08, device="cpu")
    out = {}

    def render(cli, name, *extra):
        cli.main(["render", "procedural", "-o", str(d / f"{name}.png")]
                 + COMMON + list(extra))
        out[name] = d / name

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jproc, "default_procedural_grid", lambda *a, **k: grid)
        mp.setattr(tproc, "default_procedural_grid", lambda *a, **k: grid)
        # 2 spp each, checkpointed at 2
        for case, flags in CASES.items():
            for cli, who in ((jcli, "jax"), (tcli, "port")):
                render(cli, f"{who}_{case}", "--spp", "2", *flags,
                       "--checkpoint-every", "2")
        # on to 4 spp from the reference's checkpoint and from the
        # port's, and 4 spp uninterrupted
        cb = CASES["cached_black"]
        for cli, who in ((jcli, "jax"), (tcli, "port")):
            render(cli, f"{who}_from_jax", "--spp", "4", *cb, "--resume",
                   str(d / "jax_cached_black.ckpt.npz"))
        render(tcli, "port_resumed", "--spp", "4", *cb, "--resume",
               str(d / "port_cached_black.ckpt.npz"))
        render(tcli, "port_whole", "--spp", "4", *cb)
    out["grid"] = grid
    return out


def _exr(stem):
    return read_exr_rgb(f"{stem}.exr")


@pytest.mark.parametrize("case", list(CASES))
def test_render_matches_reference(renders, case):
    want, got = _exr(renders[f"jax_{case}"]), _exr(renders[f"port_{case}"])
    assert got.shape == (32, 32, 3) and want.mean() > 0
    assert radiance_share(got, want) >= MIN_SHARE
    pw = np.asarray(Image.open(f"{renders[f'jax_{case}']}.png"), np.int32)
    pg = np.asarray(Image.open(f"{renders[f'port_{case}']}.png"), np.int32)
    assert pg.shape == pw.shape == (32, 32, 3)
    assert np.abs(pg - pw).max() <= 1
    np.testing.assert_array_equal(
        read_png(f"{renders[f'port_{case}']}.png"), pg)


def test_volume_depth_and_dof_overlay(renders):
    """`--volume-depth 2 --aov dof`: the port's overlay PNG is dof_overlay
    of its own film (from the checkpoint) exactly, agrees with the
    reference's on >= 99% of pixels within 1 of 255, and shows both
    sides of the focus band."""
    import torch

    from vpt_tpu_torch.render.film import dof_overlay, load_film
    stem = renders["port_vd2_dof"]
    got = read_png(f"{stem}_dof.png")
    want = np.asarray(Image.open(f"{renders['jax_vd2_dof']}_dof.png"),
                      np.int32)
    assert got.shape == want.shape == (32, 32, 3)
    assert np.mean(np.abs(got.astype(np.int32) - want).max(-1) <= 1) >= 0.99
    film, spp = load_film(f"{stem}.ckpt.npz", device="cpu")
    assert spp == 2
    args = tcli.build_parser().parse_args(
        ["render", "procedural", "-o", "x.png", "--aperture", "0.5",
         *COMMON])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tproc, "default_procedural_grid",
                   lambda *a, **k: renders["grid"])
        scene = tcli._load_scene(args, None, torch.device("cpu"))
    cam = tcli.default_framing(scene, 32, 32, args.fov, args.aperture)
    np.testing.assert_array_equal(got, dof_overlay(film, cam).numpy()[::-1])
    tint = got.astype(np.int32)
    assert (tint[..., 2] > tint[..., 1]).any()   # nearer than the band
    assert (tint[..., 1] > tint[..., 2]).any()   # inside it


def test_kill_and_resume_is_bit_identical(renders):
    np.testing.assert_array_equal(_exr(renders["port_resumed"]),
                                  _exr(renders["port_whole"]))


def test_resumes_reference_checkpoint(renders):
    want, got = _exr(renders["jax_from_jax"]), _exr(renders["port_from_jax"])
    assert radiance_share(got, want) >= MIN_SHARE


def test_exr_reader_reads_both_writers(tmp_path):
    """The port's EXR copy reads the reference writer's ZIP/ZIPS files
    and the reference reads the port's."""
    from vpt_tpu.utils.exr import read_exr, write_exr
    r = np.random.default_rng(0)
    ch = {"R": r.normal(size=(37, 21)).astype(np.float32),
          "Y": np.zeros((37, 21), np.float32)}
    for comp in ("none", "zip", "zips"):
        write_exr(str(tmp_path / "j.exr"), ch, compression=comp)
        texr.write_exr(str(tmp_path / "t.exr"), ch, compression=comp)
        for got in (texr.read_exr(str(tmp_path / "j.exr")),
                    read_exr(str(tmp_path / "t.exr"))):
            for k, v in ch.items():
                np.testing.assert_array_equal(got[k], v)


def _actions(parser):
    subs = next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction))
    return {name: [(a.dest, tuple(a.option_strings), a.default, a.choices,
                    a.nargs, a.type, type(a).__name__)
                   for a in sp._actions]
            for name, sp in subs.choices.items()}


def test_parser_matches_reference():
    assert _actions(tcli.build_parser()) == _actions(jcli.build_parser())


BLACK = ["--env-type", "black"]


@pytest.mark.parametrize("argv", [
    ["render", "dragon.vdb", *BLACK], ["render", "cloud.ins", *BLACK],
    ["render", "procedural", "sky.hdr", "--sharded"],
    # the Bruneton atmosphere is ported: with an option that is not
    ["render", "procedural", "--atmosphere", "--sharded"],
    ["render", "procedural", "--denoise", "nn"],
    ["render", "procedural", "--aov", "occupancy"],
    ["render", "procedural", "--atmosphere", "-o", "x.jpg"],
    ["render", "procedural", *BLACK, "--engine", "march"],
    ["render", "procedural", "--aov", "bvh"],
    ["render", "procedural", *BLACK, "--denoise", "atrous"],
    ["render", "procedural", *BLACK, "--sharded"],
    ["render", "procedural", *BLACK, "--inst-shards", "2"],
    ["render", "procedural", *BLACK, "--union", "auto"],
    ["render", "procedural", *BLACK, "--aov", "bvh"],
    ["render", "procedural", *BLACK, "-o", "x.jpg"],
    ["earth", "-o", "x.jpg"], ["view", "procedural"]])
def test_out_of_slice_exits(argv):
    """Each option outside the slice exits with a message before any
    work, naming what is not ported; nothing renders in its place."""
    with pytest.raises(SystemExit) as e:
        tcli.main(argv + ["--cpu"])
    assert "not ported" in str(e.value) or "unsupported" in str(e.value)


def _write_sky_hdr(path):
    """A 16x32 gradient map (.hdr) for the CLI's HDRI scenes."""
    from vpt_tpu_torch.utils.hdr import write_hdr
    ty = np.linspace(1.0, 0.0, 16, dtype=np.float32)[:, None, None]
    write_hdr(path, np.broadcast_to(
        np.array([0.3, 0.5, 1.0], np.float32) * ty
        + np.array([0.9, 0.6, 0.3], np.float32) * (1.0 - ty), (16, 32, 3)))


@pytest.mark.parametrize("argv", [
    ["sky.hdr", "--engine", "reference"],
    ["procedural", *BLACK, "--engine", "reference"],
    ["procedural", *BLACK, "--integrator", "volumetric"],
    ["sky.hdr", "--integrator", "volumetric"]])
def test_walk_engines_render(argv, tmp_path):
    """The reference engine and the volumetric integrator render through
    the CLI (the 16^3 grid swapped in): the PNG decodes to the frame, the
    EXR is finite and not black."""
    grid = tproc.create_procedural_grid(vmin=(-8.0,) * 3, vmax=(8.0,) * 3,
                                        scale=0.08, device="cpu")
    argv = [str(tmp_path / a) if a == "sky.hdr" else a for a in argv]
    if any(a.endswith(".hdr") for a in argv):
        _write_sky_hdr(str(tmp_path / "sky.hdr"))
    out = tmp_path / "walk.png"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tproc, "default_procedural_grid", lambda *a, **k: grid)
        tcli.main(["render", *argv, "-o", str(out), "--spp", "1"] + COMMON)
    assert read_png(str(out)).shape == (32, 32, 3)
    img = _exr(tmp_path / "walk")
    assert np.isfinite(img).all() and img.mean() > 0


def test_volumetric_with_atmosphere_exits_on_the_card():
    """The volumetric integrator's sky estimate under the Bruneton
    atmosphere runs on the card (kernel K5's NEE under the atmosphere):
    without --cpu the CLI's slice check lets it through to the render,
    resolving the atmosphere environment, where it once exited."""
    args = tcli.build_parser().parse_args(
        ["render", "procedural", "--atmosphere", "--integrator",
         "volumetric", "-o", "x.png"])
    assert not args.cpu
    assert tcli._check_render_slice(args) == "atmosphere"


@pytest.fixture(scope="module")
def env_renders(tmp_path_factory):
    """The port's renders of the environments the reference resolves
    (vpt_tpu/app/cli.py:395-398), 32x32, 1 spp, tracked shadows, on the
    16^3 grid: {name: EXR radiance}."""
    from vpt_tpu_torch.utils.hdr import write_hdr
    d = tmp_path_factory.mktemp("cli_env")
    grid = tproc.create_procedural_grid(vmin=(-8.0,) * 3, vmax=(8.0,) * 3,
                                        scale=0.08, device="cpu")
    sky = str(d / "sky.hdr")
    ty = np.linspace(1.0, 0.0, 16, dtype=np.float32)[:, None, None]
    write_hdr(sky, np.broadcast_to(
        np.array([0.3, 0.5, 1.0], np.float32) * ty
        + np.array([0.9, 0.6, 0.3], np.float32) * (1.0 - ty), (16, 32, 3)))
    argvs = {"default": ["procedural"],
             "atmosphere": ["procedural", "--env-type", "atmosphere"],
             "hdri_no_map": ["procedural", "--env-type", "hdri"],
             "black": ["procedural", "--env-type", "black"],
             "env_map": ["procedural", sky],
             "hdr_scene": [sky]}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tproc, "default_procedural_grid", lambda *a, **k: grid)
        for name, argv in argvs.items():
            tcli.main(["render", *argv, "-o", str(d / f"{name}.png"),
                       "--spp", "1"] + COMMON)
            out[name] = _exr(d / name)
    return out


def test_default_environment_is_the_simple_sky(env_renders):
    """With no --env-type the port renders the simple sky, as the
    reference does: the background corners are lit, bluer than red."""
    img = env_renders["default"]
    assert np.isfinite(img).all() and img.shape == (32, 32, 3)
    corners = img[[0, 0, -1, -1], [0, -1, 0, -1]]
    assert (corners > 0).all() and (corners[:, 2] > corners[:, 0]).all()
    np.testing.assert_array_equal(img, env_renders["atmosphere"])
    assert img.mean() > env_renders["black"].mean()


def test_hdri_renders_from_a_map_or_a_hdr_scene(env_renders):
    """The positional map and a .hdr scene give the same image (the .hdr
    scene is the procedural volume lit by its map); HDRI without a map is
    black, bit for bit."""
    img = env_renders["env_map"]
    assert np.isfinite(img).all() and img.mean() > env_renders["black"].mean()
    np.testing.assert_array_equal(img, env_renders["hdr_scene"])
    np.testing.assert_array_equal(env_renders["hdri_no_map"],
                                  env_renders["black"])
