"""`.ins` instance files (port of vpt_tpu/scene/ins.py:38-135).

The text format of the Houdini plugin (file_IO.cpp:56-226), parsed as
main.cpp:980-1102 parses it:

    line 1: <num unique vdbs>      |  "light"
    per vdb: <path>                |  <num lights>
             <num instances>       |  "px py pz r g b power" x N
             "px py pz qx qy qz qw scale" x M

The lights variant is point lights over the default procedural volume
(main.cpp:989-1018).  The volumes variant instances `.vdb` grids, whose
reader is not ported (ROADMAP A, the .vdb reader): reading its host
contents raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vpt_tpu_torch.core.device import DEFAULT_DEVICE

VDB_READER = "ROADMAP A, the .vdb reader"


@dataclass
class InsVolumeFile:
    vdb_file: str
    instances: np.ndarray  # (M, 8): px py pz qx qy qz qw scale


@dataclass
class InsFile:
    lights: np.ndarray | None = None       # (L, 7): pos rgb power
    volumes: list[InsVolumeFile] = field(default_factory=list)


def _row(line: str) -> np.ndarray:
    """The numbers of one line (np.fromstring with sep=" ")."""
    return np.array([float(v) for v in line.split()], np.float64)


def read_ins(path: str) -> InsFile:
    with open(path) as f:
        it = iter([ln.rstrip("\n") for ln in f])
    first = next(it).strip()
    out = InsFile()
    if first == "light":
        n = int(next(it).split()[0])
        rows = [_row(next(it)) for _ in range(n)]
        out.lights = np.stack(rows) if rows else np.zeros((0, 7))
        return out
    for _ in range(int(first.split()[0])):
        vdb_file = next(it).strip()
        m = int(next(it).split()[0])
        rows = [_row(next(it)) for _ in range(m)]
        out.volumes.append(InsVolumeFile(
            vdb_file=vdb_file,
            instances=np.stack(rows) if rows else np.zeros((0, 8))))
    return out


def write_ins(path: str, ins: InsFile):
    """The Houdini side's writer (file_IO.cpp:56-226)."""
    with open(path, "w") as f:
        if ins.lights is not None:
            f.write("light\n")
            f.write(f"{len(ins.lights)}\n")
            for row in ins.lights:
                f.write(" ".join(f"{v:g}" for v in row) + "\n")
            return
        f.write(f"{len(ins.volumes)}\n")
        for vf in ins.volumes:
            f.write(vf.vdb_file + "\n")
            f.write(f"{len(vf.instances)}\n")
            for row in vf.instances:
                f.write(" ".join(f"{v:g}" for v in row) + "\n")


def quaternion_to_mat4(q) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> row-vector rotation mat4, in
    float32 as vpt_tpu/core/vecmath.py:167-192 computes it
    (matrix_math.h:379-414)."""
    q = np.asarray(q, np.float32)
    x, y, z, w = q[0], q[1], q[2], q[3]
    n = x * x + y * y + z * z + w * w
    s = np.float32(2.0) / max(n, np.float32(1e-30)) if n > 0 \
        else np.float32(0.0)
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    one = np.float32(1.0)
    return np.array([[one - (yy + zz), xy + wz, xz - wy, 0.0],
                     [xy - wz, one - (xx + zz), yz + wx, 0.0],
                     [xz + wy, yz - wx, one - (xx + yy), 0.0],
                     [0.0, 0.0, 0.0, 1.0]], np.float32)


def instance_transform(grid_xform: np.ndarray, pos, quat,
                       scale) -> np.ndarray:
    """Index->world transform of one instance (main.cpp:1063-1099): the
    grid's linear part (translation zeroed), scaled, rotated by the
    quaternion, translated to the instance position; row-vector, f64."""
    g0 = np.array(grid_xform, np.float64)
    g0[3, :3] = 0.0
    s = np.diag([scale, scale, scale, 1.0])
    m = g0 @ s @ quaternion_to_mat4(quat).astype(np.float64)
    m[3, :3] = np.asarray(pos, np.float64)
    return m


def _lights_of(ins: InsFile, device):
    """The point lights of a lights-variant file; the volumes variant
    raises NotImplementedError (it needs the .vdb reader)."""
    from vpt_tpu_torch.lights.lights import PointLights
    if ins.lights is None:
        raise NotImplementedError(
            f"the .ins volumes variant instances .vdb grids "
            f"({', '.join(v.vdb_file for v in ins.volumes)}), whose reader "
            f"is not ported yet ({VDB_READER})")
    return PointLights.make(ins.lights[:, 0:3], ins.lights[:, 3:6],
                            ins.lights[:, 6], device=device)


def read_ins_host(path: str, base_dir: str | None = None,
                  device=DEFAULT_DEVICE):
    """Host contents of a `.ins` file: (host_grids, grid_ids, xforms,
    lights), the lights variant's PointLights on ``device`` over the
    default procedural volume.  ``base_dir`` would resolve the volumes
    variant's relative .vdb paths; that variant raises
    NotImplementedError."""
    from vpt_tpu_torch.volume.procedural import default_procedural_grid
    lights = _lights_of(read_ins(path), device)
    g = default_procedural_grid(device=device)
    return [g], [0], [g.transform], lights


def load_ins_scene(path: str, base_dir: str | None = None,
                   device=DEFAULT_DEVICE, **scene_kw):
    """A Scene from a `.ins` file on ``device``: the lights variant's
    point lights over the default procedural volume (``host_grid`` in
    ``scene_kw`` replaces that volume).  The file's lights take the
    place of a ``lights`` keyword, which the reference passes to
    build_scene a second time (a TypeError there)."""
    from vpt_tpu_torch.scene.scene import build_scene
    from vpt_tpu_torch.volume.procedural import default_procedural_grid
    lights = _lights_of(read_ins(path), device)
    host = scene_kw.pop("host_grid", None)
    if host is None:
        host = default_procedural_grid(device=device)
    scene_kw.pop("lights", None)
    return build_scene([host], lights=lights, device=device, **scene_kw)
