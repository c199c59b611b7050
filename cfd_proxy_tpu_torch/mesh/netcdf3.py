"""Minimal pure-NumPy NetCDF-3 (classic / 64-bit-offset) reader + writer.

The reference consumes pre-partitioned meshes through the netCDF C library
(`reader.c`; SURVEY.md §2 L1).  This sandbox has no `netCDF4`/`xarray`, so the
rebuild carries its own codec for the classic file format — enough to
round-trip the mesh schema frozen in `cfd_proxy_tpu.mesh.reader` and to stay
interoperable with any standard netCDF tool (`ncdump`, scipy.io.netcdf_file,
netCDF4): the on-disk format is the documented CDF-1/CDF-2 layout.

Scope (deliberate): non-record (fixed-size) variables only, no record
dimension, big-endian classic types (byte/char/short/int/float/double).
Mesh files never need record variables.  Files > 2 GiB use version 2
(64-bit offsets), chosen automatically.

Format reference: the public NetCDF classic format spec (CDF magic, header =
dim_list / gatt_list / var_list, 4-byte-aligned data section).

The port's copy of `cfd_proxy_tpu/mesh/netcdf3.py`: the port imports nothing of the
JAX package, so it carries its own host layer; tests/test_torch_host.py holds the
two equal (code and outputs).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from cfd_proxy_tpu_torch.utils.errors import check

# netCDF external type codes
NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6

_NC_ABSENT = b"\x00\x00\x00\x00\x00\x00\x00\x00"
_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

_TYPE_TO_DTYPE = {
    NC_BYTE: np.dtype(">i1"),
    NC_CHAR: np.dtype("S1"),
    NC_SHORT: np.dtype(">i2"),
    NC_INT: np.dtype(">i4"),
    NC_FLOAT: np.dtype(">f4"),
    NC_DOUBLE: np.dtype(">f8"),
}
_TYPE_SIZE = {NC_BYTE: 1, NC_CHAR: 1, NC_SHORT: 2, NC_INT: 4, NC_FLOAT: 4, NC_DOUBLE: 8}


def _nc_type_for(arr: np.ndarray) -> int:
    kind, size = arr.dtype.kind, arr.dtype.itemsize
    if kind == "i" and size == 1:
        return NC_BYTE
    if kind in "SU":
        # NC_CHAR is a 1-byte element type: multi-character string elements
        # would silently keep only their first byte — refuse instead
        if size > (4 if kind == "U" else 1):
            raise ValueError(
                "netCDF classic char variables are single-byte elements; "
                f"reshape {arr.dtype} strings to an S1 array of characters")
        return NC_CHAR
    if kind == "i" and size == 2:
        return NC_SHORT
    if kind == "i" and size <= 4:
        return NC_INT
    if kind == "u" and size <= 2:
        return NC_INT            # u1/u2 always fit in a signed 32-bit int
    if kind == "f" and size == 4:
        return NC_FLOAT
    if kind == "f" and size == 8:
        return NC_DOUBLE
    if kind == "u" and size == 4:
        # values above INT32_MAX would silently wrap in the >i4 cast
        raise ValueError("uint32 not representable in netCDF classic "
                         "(NC_INT is signed); cast explicitly first")
    if kind in "iu" and size == 8:
        # classic netCDF has no 64-bit integer; mesh indices fit in int32
        raise ValueError("int64 not representable in netCDF classic; cast to int32 first")
    raise ValueError(f"unsupported dtype {arr.dtype}")


def _pad4(n: int) -> int:
    return (n + 3) & ~3


@dataclass
class Dataset:
    """In-memory netCDF dataset: named dims, global attrs, named variables."""

    dims: dict[str, int] = field(default_factory=dict)
    attrs: dict[str, object] = field(default_factory=dict)
    # name -> (dim_names tuple, ndarray)
    variables: dict[str, tuple[tuple[str, ...], np.ndarray]] = field(default_factory=dict)

    def add(self, name: str, dim_names: tuple[str, ...], arr: np.ndarray) -> None:
        arr = np.asarray(arr)
        check(len(dim_names) == arr.ndim, "var %s: %d dim names for ndim %d",
              name, len(dim_names), arr.ndim)
        for dn, sz in zip(dim_names, arr.shape):
            if dn in self.dims:
                check(self.dims[dn] == sz, "dim %s: size mismatch %d vs %d",
                      dn, self.dims[dn], sz)
            else:
                self.dims[dn] = sz
        self.variables[name] = (tuple(dim_names), arr)

    def __getitem__(self, name: str) -> np.ndarray:
        dn, arr = self.variables[name]
        if arr.dtype.byteorder == ">":
            # lazily-stored big-endian mmap view (read path): convert to a
            # native-order copy on FIRST access and cache it — variables a
            # caller never touches never leave their mapped pages
            arr = arr.astype(arr.dtype.newbyteorder("="))
            self.variables[name] = (dn, arr)
        return arr


# ---------------------------------------------------------------- writing

def _write_name(out: list[bytes], name: str) -> None:
    b = name.encode()
    out.append(struct.pack(">i", len(b)))
    out.append(b + b"\x00" * (_pad4(len(b)) - len(b)))


def _attr_payload(value: object) -> tuple[int, int, bytes]:
    """Return (nc_type, nelems, padded bytes) for an attribute value."""
    if isinstance(value, str):
        b = value.encode()
        return NC_CHAR, len(b), b + b"\x00" * (_pad4(len(b)) - len(b))
    arr = np.atleast_1d(np.asarray(value))
    if arr.dtype.kind in "iu":
        arr = arr.astype(">i4")
        t = NC_INT
    else:
        arr = arr.astype(">f8")
        t = NC_DOUBLE
    raw = arr.tobytes()
    return t, arr.size, raw + b"\x00" * (_pad4(len(raw)) - len(raw))


def _write_attr_list(out: list[bytes], attrs: dict[str, object]) -> None:
    if not attrs:
        out.append(_NC_ABSENT)
        return
    out.append(struct.pack(">ii", _NC_ATTRIBUTE, len(attrs)))
    for name, value in attrs.items():
        _write_name(out, name)
        t, nelems, payload = _attr_payload(value)
        out.append(struct.pack(">ii", t, nelems))
        out.append(payload)


def write(path: str, ds: Dataset, *, version: int | None = None) -> None:
    """Write a Dataset as a classic netCDF file.

    version: None → auto (CDF-1, upgraded to CDF-2/64-bit-offset when the
    final byte offset would overflow int32); 1 or 2 to force."""
    dim_names = list(ds.dims)
    dim_index = {n: i for i, n in enumerate(dim_names)}
    for n in dim_names:
        # a 0-length fixed dim is indistinguishable from the record
        # (unlimited) dimension in the classic format — standard tools
        # misread such files; callers omit empty dims instead (reader.py)
        check(ds.dims[n] > 0,
              "netcdf3 writer: zero-length dim %r not representable in the "
              "classic format (omit the dim and its variables)", n)

    # precompute per-variable data size to know the file size / version
    var_meta = []
    for name, (dnames, arr) in ds.variables.items():
        t = _nc_type_for(arr)
        cast = arr.astype(_TYPE_TO_DTYPE[t]) if arr.dtype != _TYPE_TO_DTYPE[t] else arr
        vsize = _pad4(cast.size * _TYPE_SIZE[t])
        var_meta.append((name, dnames, t, cast, vsize))

    total_data = sum(v[4] for v in var_meta)

    # the CDF-2 spec permits the vsize header field to overflow (clamped
    # encoding) ONLY for the LAST variable; a >4GiB non-last fixed variable
    # would produce an out-of-spec header that strict external tools reject
    # (our own reader seeks by begin offsets and would not notice)
    for name, _dn, _t, _cast, vsize in var_meta[:-1]:
        check(vsize <= (1 << 32) - 4,
              "netcdf3 writer: variable %r is %d bytes; only the LAST "
              "variable may exceed 2^32-4 bytes in the classic format "
              "(reorder it last or split it)", name, vsize)

    def make_base(version: int) -> bytes:
        header: list[bytes] = [b"CDF", bytes([version]), struct.pack(">i", 0)]
        if dim_names:
            header.append(struct.pack(">ii", _NC_DIMENSION, len(dim_names)))
            for n in dim_names:
                _write_name(header, n)
                header.append(struct.pack(">i", ds.dims[n]))
        else:
            header.append(_NC_ABSENT)
        _write_attr_list(header, ds.attrs)
        return b"".join(header)

    def make_var_header(version: int, begin_of: dict[str, int]) -> bytes:
        offt = ">q" if version == 2 else ">i"
        out: list[bytes] = []
        if var_meta:
            out.append(struct.pack(">ii", _NC_VARIABLE, len(var_meta)))
            for name, dnames, t, _cast, vsize in var_meta:
                _write_name(out, name)
                out.append(struct.pack(">i", len(dnames)))
                for dn in dnames:
                    out.append(struct.pack(">i", dim_index[dn]))
                _write_attr_list(out, {})
                # vsize is an UNSIGNED header field; >=2 GiB variables are
                # legal in CDF-2 (clamped to 2^32-1 for an oversized last
                # variable, per spec) but overflow a signed '>i' pack
                out.append(struct.pack(">iI", t, min(vsize, (1 << 32) - 1)))
                out.append(struct.pack(offt, begin_of.get(name, 0)))
        else:
            out.append(_NC_ABSENT)
        return b"".join(out)

    if version is None:
        # choose the version from the EXACT final offset under CDF-1 headers —
        # a begin offset past 2^31-1 needs 64-bit offsets even if data fits
        hdr1 = len(make_base(1)) + len(make_var_header(1, {}))
        version = 1 if hdr1 + total_data <= (1 << 31) - 1 else 2
    check(version in (1, 2), "netcdf3 writer: version must be 1 or 2")

    def var_header(begin_of: dict[str, int]) -> bytes:
        return make_var_header(version, begin_of)

    base = make_base(version)
    hdr_len = len(base) + len(var_header({}))
    begin_of: dict[str, int] = {}
    pos = hdr_len
    for name, _dn, _t, _cast, vsize in var_meta:
        begin_of[name] = pos
        pos += vsize
    check(version == 2 or pos <= (1 << 31) - 1,
          "netcdf3 writer: offsets exceed CDF-1 range (header too large?)")

    with open(path, "wb") as f:
        f.write(base)
        f.write(var_header(begin_of))
        for name, _dn, t, cast, vsize in var_meta:
            check(f.tell() == begin_of[name], "netcdf3 writer: offset drift at %s", name)
            raw = cast.tobytes()
            f.write(raw)
            f.write(b"\x00" * (vsize - len(raw)))


# ---------------------------------------------------------------- reading

class _Cursor:
    def __init__(self, buf):
        self.buf = buf          # bytes or memoryview (mmap-backed)
        self.pos = 0

    def take(self, n: int):
        b = self.buf[self.pos : self.pos + n]
        check(len(b) == n, "netcdf3 reader: truncated file")
        self.pos += n
        return b

    def i4(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def u4(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def i8(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def name(self) -> str:
        n = self.i4()
        raw = self.take(_pad4(n))
        return bytes(raw[:n]).decode()


def _read_attr_list(c: _Cursor) -> dict[str, object]:
    tag, n = c.i4(), c.i4()
    attrs: dict[str, object] = {}
    if tag == 0:
        return attrs
    check(tag == _NC_ATTRIBUTE, "netcdf3 reader: bad attr tag %d", tag)
    for _ in range(n):
        nm = c.name()
        t, nelems = c.i4(), c.i4()
        nbytes = nelems * _TYPE_SIZE[t]
        raw = c.take(_pad4(nbytes))[:nbytes]
        if t == NC_CHAR:
            attrs[nm] = bytes(raw).decode()
        else:
            vals = np.frombuffer(raw, dtype=_TYPE_TO_DTYPE[t])
            attrs[nm] = vals[0].item() if vals.size == 1 else vals.copy()
    return attrs


def read(path: str) -> Dataset:
    """Read a classic netCDF file (written by this module or any netCDF tool).

    Restrictions match the writer: no record variables.

    The file is memory-mapped, not slurped: the header is parsed from mapped
    pages and each variable's data region is touched only when converted —
    CDF-2-scale (multi-GiB) partition files never need file-size RAM beyond
    the variables actually materialised.
    """
    import mmap

    with open(path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            buf = memoryview(mm)
        except (ValueError, OSError):   # empty/special file — tiny anyway
            buf = f.read()
    c = _Cursor(buf)
    magic = c.take(3)
    check(magic == b"CDF", "not a netCDF classic file: %s", path)
    version = c.take(1)[0]
    check(version in (1, 2), "unsupported netCDF version byte %d", version)
    numrecs = c.i4()
    check(numrecs in (0, -1), "record variables unsupported (numrecs=%d)", numrecs)

    tag, ndims = c.i4(), c.i4()
    dims: list[tuple[str, int]] = []
    if tag != 0:
        check(tag == _NC_DIMENSION, "bad dim tag %d", tag)
        for _ in range(ndims):
            nm = c.name()
            dims.append((nm, c.i4()))
    ds = Dataset()
    ds.dims = dict(dims)
    ds.attrs = _read_attr_list(c)

    tag, nvars = c.i4(), c.i4()
    if tag != 0:
        check(tag == _NC_VARIABLE, "bad var tag %d", tag)
        for _ in range(nvars):
            nm = c.name()
            nd = c.i4()
            dimids = [c.i4() for _ in range(nd)]
            _ = _read_attr_list(c)  # per-var attrs: parsed, not kept
            t = c.i4()
            _vsize = c.u4()   # unsigned: >=2 GiB variables are legal in CDF-2
            begin = c.i8() if version == 2 else c.i4()
            dnames = tuple(dims[d][0] for d in dimids)
            shape = tuple(dims[d][1] for d in dimids)
            count = int(np.prod(shape)) if shape else 1
            raw = buf[begin : begin + count * _TYPE_SIZE[t]]
            check(len(raw) == count * _TYPE_SIZE[t],
                  "netcdf3 reader: truncated data for variable %s", nm)
            arr = np.frombuffer(raw, dtype=_TYPE_TO_DTYPE[t]).reshape(shape)
            # store the mmap-backed big-endian VIEW: Dataset.__getitem__
            # converts (and caches) on first access, so untouched variables
            # never leave their mapped pages (true multi-GiB laziness)
            ds.variables[nm] = (dnames, arr)
    return ds
