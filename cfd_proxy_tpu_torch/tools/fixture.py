"""Pinned large-mesh fixture on the port: regenerate and check the hashes.

Counterpart of `cfd_proxy_tpu/tools/fixture.py`, on the port's own mesh
modules: the fixture is a deterministic generation recipe plus a SHA-256
manifest (`data/large_fixture.sha256.json`, shared with the reference and
read here, never written).  `verify` regenerates the partition files from
the manifest's stored recipe under `--dir` and checks every hash: the
port's files must equal the reference's byte for byte.  `generate` writes
the files and a manifest of their hashes, both under `--dir`.

    python -m cfd_proxy_tpu_torch.tools.fixture verify   --dir /tmp/fix
    python -m cfd_proxy_tpu_torch.tools.fixture generate --dir /tmp/fix2
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

# the canonical recipe (the reference's): ~831k faces, valence-skewed and
# shuffled like the benchmark meshes, partitioned at 8 and 64 ranks with 2
# ghost layers
RECIPE = {
    "nx": 64, "ny": 64, "nz": 64, "jitter": 0.05, "diag_frac": 0.2,
    "shuffle": True, "seed": 7, "ghost_layers": 2, "parts": [8, 64],
}
MANIFEST = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data",
    "large_fixture.sha256.json")
MANIFEST_NAME = "large_fixture.sha256.json"     # generate's, under --dir


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def build(out_dir: str, recipe: dict | None = None) -> dict[str, str]:
    """Write the recipe's partition files under out_dir; returns their
    hashes by file name (and "_mesh": the mesh's size)."""
    from cfd_proxy_tpu_torch.mesh.generator import generate_mesh
    from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
    from cfd_proxy_tpu_torch.mesh.reader import partition_path, write_partition

    r = recipe or RECIPE
    m = generate_mesh(r["nx"], r["ny"], r["nz"], jitter=r["jitter"],
                      diag_frac=r["diag_frac"], shuffle=r["shuffle"],
                      seed=r["seed"])
    os.makedirs(out_dir, exist_ok=True)
    hashes: dict[str, str] = {}
    for P in r["parts"]:
        parts = partition_mesh(m, P, ghost_layers=r["ghost_layers"])
        for p in parts:
            path = partition_path(os.path.join(out_dir, "large"), p.part_id, P)
            write_partition(path, p)
            hashes[os.path.basename(path)] = _sha256(path)
    hashes["_mesh"] = f"{m.npoint} points, {m.nface} faces"
    return hashes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfd_proxy_tpu_torch.tools.fixture")
    ap.add_argument("cmd", choices=["generate", "verify"])
    ap.add_argument("--dir", required=True, help="partition-file directory")
    ap.add_argument("--manifest", default=MANIFEST,
                    help="verify: the manifest to check against")
    args = ap.parse_args(argv)

    if args.cmd == "generate":
        hashes = build(args.dir)
        path = os.path.join(args.dir, MANIFEST_NAME)
        with open(path, "w") as f:
            json.dump({"recipe": RECIPE, "sha256": hashes}, f, indent=1,
                      sort_keys=True)
            f.write("\n")
        print(f"wrote {len(hashes) - 1} partition files to {args.dir}; "
              f"manifest {path}")
        return 0
    with open(args.manifest) as f:
        manifest = json.load(f)
    want = manifest["sha256"]
    # the manifest's own recipe: a later change of RECIPE here must not read
    # as corrupted files
    hashes = build(args.dir, recipe=manifest.get("recipe"))
    bad = [k for k in want if hashes.get(k) != want[k]]
    missing = [k for k in hashes if k not in want]
    if bad or missing:
        print(f"MISMATCH: {bad or ''} "
              f"{('unexpected: ' + str(missing)) if missing else ''}")
        return 1
    print(f"fixture verified: {len(want) - 1} files match the manifest")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
