"""The plain reference that decides `correct`.

The reference of a decoder that must match dav1d bit for bit is the
md5 of every picture it must output. `streams/<stem>.json` records, for
every picture of a pool stream in output order, the md5 that dav1d's
md5 muxer takes (luma rows cropped to the picture, then each chroma
plane, 8-bit samples as bytes, deeper ones as little-endian 16-bit),
recorded from an independent decoder (see each record's `md5_source`),
and the frame-header facts the roofline arithmetic reads. This package
hashes the pictures the program handed over with hashlib and numpy
alone and compares them, picture by picture, in output order. It
imports nothing of the program.
"""
from __future__ import annotations

import hashlib

import numpy as np


def picture_md5(planes, w, h, bpc, ss_hor, ss_ver) -> str:
    """md5 of one picture's visible samples, as dav1d's md5 muxer."""
    md5 = hashlib.md5()
    dtype = np.dtype("<u2") if bpc > 8 else np.dtype("u1")
    md5.update(np.ascontiguousarray(planes[0][:h, :w]).astype(
        dtype, copy=False).tobytes())
    if len(planes) > 1:
        cw = (w + ss_hor) >> ss_hor
        ch = (h + ss_ver) >> ss_ver
        for pl in planes[1:3]:
            md5.update(np.ascontiguousarray(pl[:ch, :cw]).astype(
                dtype, copy=False).tobytes())
    return md5.hexdigest()


def expected_md5s(record, unit=None) -> list:
    """The md5s a session must return in order: every picture of the
    stream, or (unit given) the one picture of that keyframe unit."""
    pics = record["pictures"]
    if unit is None:
        return [p["md5"] for p in pics]
    return [p["md5"] for p in pics if p["unit"] == unit]


def compare(sessions, records) -> dict:
    """Judge every picture the sessions returned against the record.

    sessions: dicts with `stream`, `unit` (None for a whole stream),
    `md5s` (of the pictures returned, in order), `complete` (the
    session ran to its end: every picture it owed was due) and `error`.
    Returns the counts compared, each with limit 0:
      mismatched  pictures whose md5 is not the one due at their place
                  (an extra picture counts here);
      missing     pictures a complete session owed and never returned;
      errors      sessions the program ended with an exception;
    and `attempted` (pictures due) and `failed` (mismatched + missing).
    """
    mismatched = missing = errors = attempted = 0
    for s in sessions:
        want = expected_md5s(records[s["stream"]], s["unit"])
        got = s["md5s"]
        mismatched += sum(1 for i, m in enumerate(got)
                          if i >= len(want) or m != want[i])
        due = len(want) if s["complete"] else min(len(got), len(want))
        missing += max(0, due - len(got))
        attempted += max(due, len(got))
        errors += 1 if s["error"] else 0
    return {"mismatched": mismatched, "missing": missing, "errors": errors,
            "attempted": attempted, "failed": mismatched + missing}


def requantized(planes, bpc) -> list:
    """The control's pictures: the samples one step of precision below
    the stated depth (8 bits: 7 significant bits; 10 and 12 bits: 8)."""
    drop = 1 if bpc == 8 else bpc - 8
    return [(np.asarray(p) >> drop) << drop for p in planes]
