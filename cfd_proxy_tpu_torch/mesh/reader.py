"""Partitioned-mesh netCDF reader/writer — the `reader.c` analogue.

One netCDF file per partition (same convention as the reference: the
partitioning is done offline, the benchmark only reads; SURVEY.md §1, §2 L1).
The reference mount was empty during the survey, so the exact upstream
variable names could not be recovered; per SURVEY.md §8 the schema defined
HERE is the frozen spec (re-alignment to upstream names is mechanical if the
reference surfaces later).

Schema (all fixed dims; netCDF classic via cfd_proxy_tpu.mesh.netcdf3):

  dims:   points, dim3=3, two=2, faces, comm_entries, sendtotal, recvtotal
  attrs:  part_id, npart, nowned, ghost_layers
  vars:   coords(points,dim3) f64       point coordinates, owned-first layout
          global_ids(points) i32        global point id per local point
          volume(points) f64            dual-cell volume
          faces(faces,two) i32          local point ids, p0 < p1
          normals(faces,dim3) f64       face normal (flips sign with swap)
          commpartner(comm_entries) i32 neighbor partition id
          commround(comm_entries) i32   exchange round (ghost depth - 1)
          sendcount(comm_entries) i32 / recvcount(comm_entries) i32
          sendidx(sendtotal) i32        concatenated per-entry gather lists
          recvidx(recvtotal) i32        concatenated per-entry scatter lists

Comm dims are omitted entirely for partitions with no neighbors (netCDF
classic cannot represent fixed dims of length 0).

The port's copy of `cfd_proxy_tpu/mesh/reader.py`: the port imports nothing of the
JAX package, so it carries its own host layer; tests/test_torch_host.py holds the
two equal (code and outputs).
"""

from __future__ import annotations

import numpy as np

from cfd_proxy_tpu_torch.mesh import netcdf3
from cfd_proxy_tpu_torch.mesh.model import CommEntry, MeshPartition
from cfd_proxy_tpu_torch.utils.errors import check

SCHEMA_VERSION = 1


def partition_path(prefix: str, part_id: int, npart: int) -> str:
    """File naming convention: <prefix>.<npart>p.<part_id>.nc"""
    return f"{prefix}.{npart}p.{part_id}.nc"


def write_partition(path: str, part: MeshPartition) -> None:
    part.validate()
    ds = netcdf3.Dataset()
    ds.attrs = {
        "schema_version": SCHEMA_VERSION,
        "part_id": part.part_id,
        "npart": part.npart,
        "nowned": part.nowned,
        "ghost_layers": part.nrounds,
    }
    ds.add("coords", ("points", "dim3"), part.coords.astype(np.float64))
    ds.add("global_ids", ("points",), part.global_ids.astype(np.int32))
    ds.add("volume", ("points",), part.volume.astype(np.float64))
    ds.add("faces", ("faces", "two"), part.faces.astype(np.int32))
    ds.add("normals", ("faces", "dim3"), part.normals.astype(np.float64))
    if part.comm:
        ds.add("commpartner", ("comm_entries",),
               np.array([e.partner for e in part.comm], np.int32))
        ds.add("commround", ("comm_entries",),
               np.array([e.round for e in part.comm], np.int32))
        ds.add("sendcount", ("comm_entries",),
               np.array([e.sendidx.size for e in part.comm], np.int32))
        ds.add("recvcount", ("comm_entries",),
               np.array([e.recvidx.size for e in part.comm], np.int32))
        sendidx = np.concatenate([e.sendidx for e in part.comm]).astype(np.int32)
        recvidx = np.concatenate([e.recvidx for e in part.comm]).astype(np.int32)
        if sendidx.size:
            ds.add("sendidx", ("sendtotal",), sendidx)
        if recvidx.size:
            ds.add("recvidx", ("recvtotal",), recvidx)
    netcdf3.write(path, ds)


def read_partition(path: str) -> MeshPartition:
    ds = netcdf3.read(path)
    check(ds.attrs.get("schema_version") == SCHEMA_VERSION,
          "unsupported mesh schema version in %s", path)
    comm: list[CommEntry] = []
    if "commpartner" in ds.variables:
        partners = ds["commpartner"]
        rounds = ds["commround"]
        scount = ds["sendcount"]
        rcount = ds["recvcount"]
        sendidx = ds["sendidx"] if "sendidx" in ds.variables else np.zeros(0, np.int32)
        recvidx = ds["recvidx"] if "recvidx" in ds.variables else np.zeros(0, np.int32)
        # counts must cover the concatenated index arrays exactly — numpy
        # slicing clamps silently, so an inconsistent/truncated file would
        # otherwise surface as a confusing comm mismatch on another rank
        check(int(scount.sum()) == sendidx.size,
              "%s: sendcount sums to %d but sendidx holds %d entries",
              path, int(scount.sum()), sendidx.size)
        check(int(rcount.sum()) == recvidx.size,
              "%s: recvcount sums to %d but recvidx holds %d entries",
              path, int(rcount.sum()), recvidx.size)
        soff = np.concatenate([[0], np.cumsum(scount)])
        roff = np.concatenate([[0], np.cumsum(rcount)])
        for i in range(partners.size):
            comm.append(CommEntry(
                partner=int(partners[i]),
                round=int(rounds[i]),
                sendidx=sendidx[soff[i]: soff[i + 1]].copy(),
                recvidx=recvidx[roff[i]: roff[i + 1]].copy(),
            ))
    part = MeshPartition(
        part_id=int(ds.attrs["part_id"]),
        npart=int(ds.attrs["npart"]),
        nowned=int(ds.attrs["nowned"]),
        coords=ds["coords"],
        global_ids=ds["global_ids"],
        faces=ds["faces"],
        normals=ds["normals"],
        volume=ds["volume"],
        comm=comm,
    )
    part.validate()
    return part
