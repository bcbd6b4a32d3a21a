"""The traffic generator: decode sessions on the API.

A traffic mix (traffic/<name>.json) is data that this module reads:

  loop               the loop that orders the sessions in time,
                     loops/<loop>.py, found by name ("closed": one
                     client, the next session when the last has ended)
  session            "stream": a session decodes every temporal unit of
                     the next stream of the pool; "keyframe": a request
                     decodes one keyframe unit of the next stream
  decode_frame_type  Settings.decode_frame_type of every session
                     (0 all frames, 3 keyframes only: dav1d's
                     --decodeframetype key)

Each session is a new `Decoder(Settings(...))` that is sent every unit
it decodes, then drained through `get_picture` (a demuxer with buffered
input, which lets the decoder parse ahead), then `close`d. A picture
counts once `get_picture` has returned it, with its host planes; the
planes are kept and hashed once the window has closed.
"""
from __future__ import annotations

import time


def pool_items(traffic, streams) -> list:
    """What a session of this mix draws: (stream name, keyframe unit or
    None for the whole stream), in a fixed order."""
    kind = traffic["session"]
    if kind == "stream":
        return [(name, None) for name in sorted(streams)]
    if kind == "keyframe":
        return [(name, u) for name in sorted(streams)
                for u in streams[name].record["key_units"]]
    raise ValueError(f"unknown session kind {kind!r}")


def hand_over(pic):
    """What the caller keeps of a returned picture: its host planes and
    the geometry its md5 is taken over."""
    return (list(pic.planes), pic.w, pic.h, pic.bpc, pic.ss_hor, pic.ss_ver)


class Driver:
    """Runs the sessions of one cell against the program's API."""

    def __init__(self, api, settings: dict, streams: dict, traffic: dict,
                 clock=time.perf_counter):
        self.api = api
        self.settings = dict(settings)
        self.settings["decode_frame_type"] = int(
            traffic.get("decode_frame_type", 0))
        self.streams = streams
        self.traffic = traffic
        self.items = pool_items(traffic, streams)
        self.clock = clock

    def session(self, name, unit, deadline=None) -> dict:
        """One session; stops early (incomplete) at the first picture
        returned after `deadline`."""
        stream = self.streams[name]
        units = stream.units if unit is None else [stream.units[unit]]
        rec = {"stream": name, "unit": unit, "start": self.clock(),
               "returns": [], "pictures": [], "complete": False,
               "error": None}
        try:
            dec = self.api.Decoder(self.api.Settings(**self.settings))
            try:
                self._feed(dec, units, rec, deadline)
            finally:
                dec.close()
        except Exception as e:      # a failed session is counted, not fatal
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["complete"] = True
        rec["end"] = self.clock()
        return rec

    def _feed(self, dec, units, rec, deadline):
        for u in units:
            dec.send_data(u)
        while True:
            pic = dec.get_picture()
            if pic is None:
                break
            t = self.clock()
            rec["returns"].append(t)
            rec["pictures"].append(hand_over(pic))
            if deadline is not None and t > deadline:
                return
        rec["complete"] = True

    def warm(self) -> list:
        """Each item of the pool once, in a fixed order."""
        return [self.session(name, unit) for name, unit in self.items]
