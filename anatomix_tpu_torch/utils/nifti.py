"""Minimal native NIfTI-1 reader/writer (no nibabel dependency).

Handles the cases the anatomix workloads need: .nii / .nii.gz, the common
numeric dtypes, scl_slope/scl_inter scaling, and sform/qform affines.
Volumes are returned in the same (Fortran-ordered) index convention nibabel
uses, so shapes and voxel values match `nib.load(...).get_fdata()`.
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _quaternion_affine(hdr) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    qfac = -1.0 if hdr["pixdim"][0] < 0 else 1.0
    R = np.array(
        [
            [
                a * a + b * b - c * c - d * d,
                2 * (b * c - a * d),
                2 * (b * d + a * c),
            ],
            [
                2 * (b * c + a * d),
                a * a + c * c - b * b - d * d,
                2 * (c * d - a * b),
            ],
            [
                2 * (b * d - a * c),
                2 * (c * d + a * b),
                a * a + d * d - b * b - c * c,
            ],
        ]
    )
    pix = np.array(
        [hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3] * qfac]
    )
    aff = np.eye(4)
    aff[:3, :3] = R * pix
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def read_nifti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a .nii/.nii.gz file -> (data float64-compatible array, affine).

    Matches `nib.load(path).get_fdata()` semantics: returns floating data
    with scl_slope/inter applied.
    """
    with _open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 348:
        raise ValueError(f"Not a NIfTI-1 file: {path}")

    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != 348:
        endian = ">"
        if struct.unpack_from(">i", raw, 0)[0] != 348:
            raise ValueError(f"Bad NIfTI header in {path}")

    def u(fmt, off):
        return struct.unpack_from(endian + fmt, raw, off)

    dim = u("8h", 40)
    datatype = u("h", 70)[0]
    pixdim = u("8f", 76)
    vox_offset = u("f", 108)[0]
    scl_slope = u("f", 112)[0]
    scl_inter = u("f", 116)[0]
    qform_code = u("h", 252)[0]
    sform_code = u("h", 254)[0]
    quatern = u("6f", 256)  # b, c, d, qoffset x/y/z
    srow_x = u("4f", 280)
    srow_y = u("4f", 296)
    srow_z = u("4f", 312)
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"Bad NIfTI magic in {path}")

    ndim = dim[0]
    shape = tuple(int(s) for s in dim[1: 1 + ndim])
    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype {datatype} in {path}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=np_dtype, count=count, offset=int(vox_offset)
    )
    data = data.reshape(shape, order="F").astype(np.float64)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter

    if sform_code > 0:
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]])
    elif qform_code > 0:
        hdr = {
            "quatern_b": quatern[0],
            "quatern_c": quatern[1],
            "quatern_d": quatern[2],
            "qoffset_x": quatern[3],
            "qoffset_y": quatern[4],
            "qoffset_z": quatern[5],
            "pixdim": pixdim,
        }
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag(list(pixdim[1:4]) + [1.0])
    return data, affine


def write_nifti(
    path: str, data: np.ndarray, affine: np.ndarray | None = None
) -> None:
    """Write a .nii/.nii.gz with an sform affine (float32/named dtypes)."""
    data = np.asarray(data)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)
    if affine is None:
        affine = np.eye(4)
    affine = np.asarray(affine, np.float32)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    ndim = data.ndim
    dims = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    # pixdim from affine column norms
    pix = [0.0] + [
        float(np.linalg.norm(affine[:3, i])) or 1.0 for i in range(3)
    ] + [1.0] * 4
    struct.pack_into("<8f", hdr, 76, *pix)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = scanner
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(
        order="F"
    )
    with _open(path, "wb") as f:
        f.write(payload)


def load_volume(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read .nii/.nii.gz/.npy/.npz -> (data, affine)."""
    p = str(path)
    if p.endswith((".nii", ".nii.gz")):
        return read_nifti(p)
    if p.endswith(".npy"):
        return np.load(p), np.eye(4)
    if p.endswith(".npz"):
        z = np.load(p)
        key = "data" if "data" in z.files else z.files[0]
        aff = z["affine"] if "affine" in z.files else np.eye(4)
        return z[key], aff
    raise ValueError(f"Unsupported volume format: {path}")


def save_volume(path: str, data: np.ndarray, affine=None) -> None:
    p = str(path)
    if p.endswith((".nii", ".nii.gz")):
        write_nifti(p, data, affine)
    elif p.endswith(".npy"):
        np.save(p, data)
    elif p.endswith(".npz"):
        np.savez(
            p, data=data, affine=affine if affine is not None else np.eye(4)
        )
    else:
        raise ValueError(f"Unsupported volume format: {path}")
