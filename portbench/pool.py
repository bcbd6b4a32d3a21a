"""The pool's streams: IVF temporal units, checked against their record.

The benchmark reads the IVF container itself (a 32-byte file header,
then a 12-byte header before each temporal unit) and hands the program
the temporal units' bytes only.
"""
from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass

from .spec import HERE, load_json

STREAM_DIR = os.path.join(HERE, "streams")
RECORD_DIR = os.path.join(HERE, "reference", "streams")


def ivf_units(data: bytes) -> list:
    """The temporal units of an IVF file, in order."""
    if len(data) < 32 or data[:4] != b"DKIF" or data[8:12] != b"AV01":
        raise ValueError("not an AV1 IVF file")
    hdr = struct.unpack_from("<H", data, 6)[0]
    off = max(hdr, 32)
    units = []
    while off + 12 <= len(data):
        size = struct.unpack_from("<I", data, off)[0]
        off += 12
        if off + size > len(data):
            raise ValueError("truncated IVF frame")
        units.append(data[off:off + size])
        off += size
    return units


@dataclass
class Stream:
    name: str             # the file name under streams/
    units: list           # temporal units (bytes)
    record: dict          # reference/streams/<stem>.json


def load_stream(name: str, stream_dir=STREAM_DIR,
                record_dir=RECORD_DIR) -> Stream:
    """A stream of the pool with its record; raises if the bytes are not
    those the record's md5s were taken from."""
    with open(os.path.join(stream_dir, name), "rb") as f:
        data = f.read()
    record = load_json(os.path.join(record_dir,
                                    os.path.splitext(name)[0] + ".json"))
    sha = hashlib.sha256(data).hexdigest()
    if sha != record["sha256"]:
        raise ValueError(f"{name}: sha256 {sha} is not the recorded "
                         f"{record['sha256']}")
    units = ivf_units(data)
    if len(units) != record["units"]:
        raise ValueError(f"{name}: {len(units)} temporal units, the record "
                         f"has {record['units']}")
    return Stream(name=name, units=units, record=record)
