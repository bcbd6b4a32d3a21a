"""Chip smoke test of the PyTorch/CUDA port (dav1d_tpu_torch) on one GPU.

Run from the repo root with no arguments: python3 chip_smoke.py

Phases, each printing one JSON line; any mismatch raises, so the script
exits nonzero and prints no "ok" line:

1. device     - the card, its power limit, torch's CUDA version,
                nvcc/ninja
2. build      - native/libstagea.so (make) and the twelve sm_90a kernels
                (deblock, mc_put, mc_comp, itx_add, mc_warp, mc_obmc,
                cdef, lr_wiener, lr_sgr, superres, film_grain, ipred;
                one nvcc each), all started together
3. kernel     - the deblock kernel against its plain torch version on
                the card (torch.equal), bd 8/10/12, luma/chroma, each
                direction alone (the other direction's edges inactive,
                against the plain pass) and both in one launch, on small
                shapes,
                shapes whose 64x64 tiles end ragged, the 1080p and 4K
                planes, and whole 4:2:0 frames in one launch; the device
                time of one 1080p frame's deblock (all device work and
                the kernel alone), wrapper and plain ms, and the bound
                for the fused bytes and for the two-pass bytes
4. kernel_mc  - the put and compound kernels against their plain
                versions (torch.equal): bd 8/10/12, every put size
                2..128 with every filter type (8-tap and bilinear),
                subpel and integer (copy) motion, and windows across
                every frame edge, put tables that end every class in a
                ragged block, and three such tables as the planes of one
                launch; compounds with all four
                combine modes, wedge masks of classes 16 and 32 for every
                layout, and the seg mask from luma to chroma; compound
                tables that end every class in a ragged kernel block and
                split jobs larger than 32x32 into tiles
5. kernel_itx - the residual kernel against its plain version: all 19
                transform sizes with every valid (row, column) kind pair,
                plus WHT; coefficients at the full range; tables that
                end every class in a ragged kernel block; bd 8/10/12
6. kernel_warp_obmc - the warp and OBMC kernels against their plain
                versions (torch.equal): bd 8/10/12, 4:2:0, 4:2:2 and
                4:4:4, every plane in one launch; warps with random and
                extreme shears (filter rows 0 and 192), windows inside,
                across every frame edge and wholly outside it, on a
                table that fills its last block of 8 warps and one that
                ends it ragged; every lap geometry the emitter writes
                with every filter type, top and left laps on the same
                blocks in one launch (top before left), laps cut at the
                plane's right and bottom edges, lap counts that are not
                multiples of a block's 3 laps
7. kernel_filters - the CDEF, Wiener and SGR kernels against their
                plain versions (torch.equal) on every case of
                ops/kernel_cases.py cdef_cases, lr_cases and
                frame_cases: bd 8/10/12, monochrome, 4:2:0, 4:2:2
                and 4:4:4, direction-search extremes and exact cost ties,
                every strength, crops that end inside the padded planes,
                tiles wholly outside the crop; every unit size and stripe
                height, the 16 edge-flag combinations, Wiener taps at
                their limits, every SGR parameter row, SGR's int32
                overflows at 12 bit; the one-launch Wiener and SGR of a
                frame's planes of different shapes, every edge flag at
                both plane edges
8. kernel_superres_grain - the super-res and film grain kernels
                against their plain versions (torch.equal) at 1080p:
                super-res to 1920 columns from 960 and 1280, every plane
                and the pre-CDEF snapshot in one launch; the grain of a
                1920x1080 frame with overlap on and off and the flag
                combinations of kernel_cases.GRAIN_VARIANTS (chroma
                scaling from luma, restricted range with and without
                is_id, copied planes); bd 8/10/12, monochrome, 4:2:0,
                4:2:2, 4:4:4; for the main path's shapes (sr-1080p's,
                fg-1080p's) and a few other layouts and depths, the
                launch's device us (median of 5 in a trace; the main
                shapes over 5 traces, with each trace's median), the
                floor below which a trace is retaken, the plain
                version's ms and the bound; then the small cases of
                tests/test_torch_cuda.py, checked only (odd sizes, 8192
                columns, planes padded to 4 columns whose last super-res
                tile or grain unit the plane cuts, sources narrower than
                a staged span), and the persistent grids' blocks a SM
9. kernel_ipred - the intra-leftover frame kernel against plan_plain
                (torch.equal), one launch a plan: every
                ops/kernel_cases.py ipred_case as a one-level plan (bd
                8/10/12; 4:2:0, 4:2:2, 4:4:4, monochrome; every family at
                every geometry 4..64 it takes over every plane; units cut
                by the plane's right and bottom edges; edges from the
                availability walk, constant fills and tlf) and every
                plan_case (three levels with residuals and WHT jobs);
                the ptxas registers, blocks a SM and shared bytes; then
                the whole plan of the first inter frame of s31 and of s7
                with the leftovers forced onto the device, on its
                captured planes: torch.equal, the launch's device us,
                the plain version's ms, the bound, the grid, the levels,
                units, residual jobs and grid barriers
10. kernel_real- the first 2 temporal units of the s7 stream, then of the
                s33 stream and of the s31 stream, decoded on cuda with
                every launch of the inter frame checked against the
                plain version on the same inputs (s7: put, compound,
                residual; s33 and s31: those, warp and OBMC); then, on
                those inputs, each kernel's
                device time (torch.profiler), per launch too, beside its
                block count and the time of a launch of its largest
                block (warp: its first tile) alone, the floor below
                which a launch's reading is retaken and, after 3
                traces, replaced by CUDA events'; the plain version's ms
                and the bound; the
                same for the CDEF, Wiener and SGR launches of the inter
                frame, rerun on the planes and tables the decode gave
                them (torch.equal); and the deblock of that frame's
                planes and maps (torch.equal, device time beside the
                synthetic frame's)
11. slice      - the 1080p keyframe of bench_streams/1920x1080_8b_flt_s31
                _enc.ivf through Decoder(Settings(decode_frame_type=3))
                on cuda: one picture, the expected md5, per-stage wall
                ms, and the kernel launch counts of this path's run
12. hbd       - the same for the 4K 10-bit keyframe
13. inter     - all 8 frames of bench_streams/1920x1080_8b_flt_s7.ivf
                through Decoder(Settings()) on cuda: per-picture and
                stream md5s, the launch counts of this run (put,
                compound, residual, deblock, CDEF, Wiener and SGR > 0;
                s7 has no warp or OBMC), stage ms, wall ms (median of 3), the device idle
                share and per-kernel device ms of one profiled decode,
                and from one more, synchronous (n_threads=1), the device
                ms of the work each stage launched (CDEF, Wiener and SGR
                among them; credited through the runtime calls the host
                made inside the stage, and the count of stages in which
                a kernel launched but nothing was credited: such a trace
                is retaken, and after 3 each stage's CUDA-event ms are
                given instead, noted in the credit's `timer`) beside
                their bounds per picture
14. inter_hbd - the same for the first 2 temporal units of
                bench_streams/3840x2160_10b_flt_s11.ivf (4K 10-bit)
15. inter_main - the main path: all 8 frames of the primary bench stream
                bench_streams/1920x1080_8b_flt_s31_enc.ivf, as inter,
                each of its nine kernels launched (count > 0)
16. inter_main_hbd - the same for the first 2 temporal units of
                bench_streams/3840x2160_10b_flt_s33_enc.ivf (4K 10-bit)
17. golden_walks - the GOLDEN_WALKS streams (tests/data/torch_golden/:
                interintra, blocks on scaled references with 8-tap and
                bilinear filters, scaled compounds, warped compounds of
                global motion, 4:4:4 intrabc frames) decoded on cuda to
                their golden md5s, i444-intrabc's frames through the
                host intrabc walk, every other stream's leftover blocks
                through the host golden inter walk
18. collector - s31's first 3 temporal units (full 1920x1080 width)
                decoded on cuda on the native emitter's route and on the
                Python collector walk (DAV1D_TPU_INTERJOBS=python), each
                picture on MD5S_S31; per inter frame each route's
                inter.* stage ms (inter.emit_jobs against inter.walk);
                then the GOLDEN_WALKS and LO_STREAMS streams under
                DAV1D_TPU_INTERJOBS=python to their golden md5s
19. sharded   - the sharded decode (ROADMAP item 10) on meshes of
                logical shards round-robin over the cards present (every
                shard on cuda:0 with one card: the cost of sharding, not
                a scaling result): s31's first 3 temporal units without
                a mesh and on 2 and 4 shards, each picture on MD5S_S31,
                every main-path kernel launched, no ipred; untimed walls
                in turns, stage ms; the mesh streams (MESH_MD5S) at 1,
                2, 4 and 8 shards on their recorded md5s; on s31 frame 1
                at 4 shards the sharded deblock, CDEF and LR held to
                their single-device kernels over every shard's owned
                columns (torch.equal), itx_sharded_check and its bound,
                and per kernel the launches, device us of a shard launch
                and the bound over its ext planes' bytes, beside the
                frame unsharded
20. leftovers  - s31, s7 and s21_realistic decoded whole with the
                leftovers forced onto the device (DAV1D_TPU_LO=device)
                and onto the host (=host): the same pictures, each on
                its recorded md5s; on the device route the ipred
                kernel launched, no fallback, no row fetched back; per
                frame both routes' stage ms (inter.lo_build,
                inter.lo_device against the host route's fetch, replay
                and upload) and bytes crossing (the plan's tables in the
                upload, the rows fetched and uploaded) beside the
                leftover, level and unit counts, untimed walls in
                turns; then the five LO_STREAMS (GOLDEN_DIR) under
                =device to their golden md5s
21. sr-1080p, fg-1080p, fg-1080p-10b - the 1080p super-res and film
                grain streams (GOLDEN_DIR, BIG_POST_FILTERS) as the
                stream phases, their kernel launched; the timed decode
                with the grain LUTs' memo cold (stage fg.luts)
22. post_filters - the small super-res and film grain streams
                (POST_FILTERS) decoded on cuda to their golden md5s,
                each launching its kernel
23. golden_route - the golden host route (DAV1D_TPU_BACKEND=numpy,
                default Settings()): the GOLDEN_WALKS, POST_FILTERS and
                LO_STREAMS streams and a mesh stream with a 2-shard mesh
                in the Settings on their recorded md5s, no kernel
                launched and no device memory allocated; then one
                stream of each family on the device route to the same
                pictures; the route's seconds
24. mc_batch  - dav1d_tpu's batched per-block MC programs in their
                plain torch versions (ops/mc.py `_put8_fn` ...
                `_residual_scatter_fn`; no kernel of their own) on the
                card and on the CPU from the same seeded inputs
                (kernel_cases.mc_batch_cases), bd 8/10/12: torch.equal
25. pipeline  - the Stage-B frame pipeline's depth: s31's 8 frames at
                Stage-B depths 1-4 (DAV1D_TPU_STAGEB_DEPTH =
                max_frame_delay = d) in bench.py's loop (every unit
                sent, then the pictures drained), and at the default
                depth in the CLI's loop (drained after each unit); one
                warm-up each, then 3 walls each in turns, every decode
                on MD5S_S31; per case the walls' median and spread, the
                blocked ms of utils.timing's spans pipeline.submit_wait
                (the main thread in submit_split), pipeline.ref_wait
                (workers on reference promises) and api.wait (the
                caller on output promises), the launches of its first
                counted decode; the winning depth; then whole s33 (4 pictures)
                at the default depth on MD5S_S33_WHOLE
26. kernels   - the per-kernel summary line (launches from inter_main,
                super-res's from sr-1080p, film grain's from fg-1080p;
                device, plain and bound ms from s31 frame 1 in
                kernel_real, the deblock's from the synthetic frame,
                super-res's and film grain's from their 1080p cases of
                kernel_superres_grain; ipred's launches from s31's
                device-route decode in leftovers, its times from s31
                frame 1's plan in kernel_ipred)

then the card's name and power limit, and the final {"ok": true, ...}
line.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# md5 of the decoded keyframe, from dav1d_tpu's golden numpy path
# (DAV1D_TPU_BACKEND=numpy, Settings(decode_frame_type=3, n_threads=1),
# dav1d_tpu.utils.muxers.Md5Muxer) on the same stream
MD5_1080P = "25ead3c156609f2b398c7f4f14141b23"
# same recipe on bench_streams/3840x2160_10b_flt_s33_enc.ivf
MD5_4K10 = "2ed9103fb6b4e5d644968bac73475bed"
STREAM_1080P = "bench_streams/1920x1080_8b_flt_s31_enc.ivf"
STREAM_4K10 = "bench_streams/3840x2160_10b_flt_s33_enc.ivf"
# every picture of bench_streams/1920x1080_8b_flt_s7.ivf (8 temporal
# units, inter frames) and the md5 of one muxer over all 8, from
# dav1d_tpu's golden numpy path (DAV1D_TPU_BACKEND=numpy,
# Settings(n_threads=1), dav1d_tpu.utils.muxers.Md5Muxer)
STREAM_S7 = "bench_streams/1920x1080_8b_flt_s7.ivf"
MD5S_S7 = ["f17212bafb21900b1d1682880fb6f167",
           "c5e7cfa0696414def0c51602b95ac49b",
           "c1e35f23c5864fc12bfdaa85d28fbfa5",
           "448e91e7d149d92fcceff90e33655305",
           "1cdd9d19b811b695889d8da7798d46c3",
           "f2bb710b4217bbb3c4ac849a422295dc",
           "6ccc53c6ed3f566c51bc42f6aabc9981",
           "812386a128296b52fd17ee0d812a3a4e"]
MD5_S7 = "3c030b2d9bdfdd923d5eb6314e4e1c10"
# the same recipe on the first 2 temporal units (keyframe + one inter
# frame) of the 4K 10-bit stream
STREAM_S11 = "bench_streams/3840x2160_10b_flt_s11.ivf"
MD5S_S11 = ["dfe5383e5aaa40b4d9741cb2a798e26d",
            "b5c3325247c7fcc06af5ae5e7b8b84fa"]
MD5_S11 = "8c08bc5b1fce7625d9bd0ab7abf1a9dc"
# every picture of the primary bench stream, STREAM_1080P (8 temporal
# units; warp and OBMC in every inter frame), and the md5 of one muxer
# over all 8: the same recipe as MD5S_S7
MD5S_S31 = ["25ead3c156609f2b398c7f4f14141b23",
            "5e6a4663747fa5d3501a91cee0010cd7",
            "3d7a9af010fcf8a34b96d78bbf4a86ad",
            "b8dc2a8916f0b039443728f01a505066",
            "46e349a0177fbe27a6f1d106e05e2c5f",
            "e855a67370e045a0655dbb3173b99686",
            "12ad99c22c3d2e0abb9dcde301e9c57c",
            "3c6dd14ac8b0e14cd938132520dd9c31"]
MD5_S31 = "2028903f9e5e69af98b0348d5e246e13"
# the same recipe on the first 2 temporal units of STREAM_4K10
MD5S_S33 = ["2ed9103fb6b4e5d644968bac73475bed",
            "b002aae1da5dad11bfaeb690e02324eb"]
MD5_S33 = "9c5ef1fd85042a0f5a78c9e22a1aad6f"
# whole STREAM_4K10 (4 pictures) and whole s21_realistic (8), per
# picture and over the stream: the port's golden host route and
# dav1d_tpu's golden numpy path gave the same (tools/torch_golden_md5s.py)
MD5S_S33_WHOLE = MD5S_S33 + ["0ea3a49559a62da3697d5c0361b0634e",
                             "b289b5e89d996ffdcd398f3db7f16936"]
MD5_S33_WHOLE = "efde4596f0e92078596e7f3718950adc"
STREAM_S21 = "bench_streams/1920x1080_8b_flt_s21_realistic.ivf"
MD5S_S21 = ["4f8685f869bd6b58685032fc33e76148",
            "88b1e76baec5b245a6811512e8399a78",
            "c383b45c31ec8260db6b347d81014be9",
            "06bc52ee7b1442c41dd15d74a928ed16",
            "8318eba61c0e7ac90dc381e171779043",
            "bd715cb6979b2a20ede813ac294660b1",
            "cd9ce8a7cfbfec0cce39391df9768dac",
            "13c63c4030659a15295efab93cc7efe0"]
MD5_S21 = "63042eb16c0d77b60d33b02bf5cc152d"
# the streams of the host golden walks (tests/torch_port_cases.py
# GOLDEN_WALKS: leftovers that are not pure intra, intrabc frames),
# committed under GOLDEN_DIR: per picture and over the stream, the md5s
# of dav1d_tpu's golden numpy path (the recipe of MD5S_S7)
GOLDEN_DIR = "tests/data/torch_golden"
GOLDEN_WALKS = {
    "interintra": ([
        "b51d9fe04f7b1ccda13f06c37c4d02a7",
        "bb082a011dfad46646abc50b00223c09",
        "c9694df0a7d74d45682707a660ef440c",
        "858ff9c3524b8d239a18f97739a0f68d",
        "e901f9863a40740c31d979c444973cf0"],
        "082cc584f3404d73a4470fe63e04f663"),
    "scaled-ref": ([
        "3a7b61513ad272ec99fad7569eeee006",
        "1d09e5943b3b265c2c6d454f54cf7ff6",
        "1f80038e5848d9789015ce697b359adf"],
        "3deb78aea7a4adaa2ad81f348df5c161"),
    "scaled-ref-bilin": ([
        "fc370c12cc1686efc7a11cf6665600ff",
        "5ee7278384fda49bde370bf140188200",
        "a6f5a4989e5350fe5dc5888ff59f9ed1"],
        "aa7f923769e695e542ead4b731386a0f"),
    "scaled-ref-compound": ([
        "de905a63f314787e5b62b570a27d261a",
        "376e147ebb3a9c44f7d952363ffaca29",
        "d8349135dd7437c042269b79d78a0f4f",
        "19b6fd60f1009ec7d99322cce55b6f90"],
        "dbe88cf410ac60997573bb2be5ca15c5"),
    "gmv-compound": ([
        "c592adce0c1ce94510b3cb0b99c0b1f2",
        "fd5c4363073048b8f999e019c3126afc",
        "9373ccbd697084195846ab77f58803c7",
        "e92965be78ad51615be9ddb3b013a759"],
        "0c6952401fb7efa5c3b3b2ef74ec19f4"),
    "i444-intrabc": ([
        "d5ba24a049e6d0e44d9a01a11b49b424",
        "39df4a5e05d890c910eef9d5442e01f5"],
        "4e0798ea6c5711b258752c57151ab9f9")}
# the super-res and film grain streams of the post_filters phase
# (tests/torch_port_cases.py POST_FILTERS: the configs of the same
# names in tests/test_e2e_superres.py, tests/test_e2e_layouts.py and,
# fg-*, tests/test_e2e_filmgrain.py), committed under GOLDEN_DIR: per
# picture and over the stream, the md5s of dav1d_tpu's golden numpy
# path with grain applied (the recipe of MD5S_S7)
POST_FILTERS = {
    "sr-inter-filters": ([
        "133c203a158880e6f227485f3f51d1e0",
        "553458a4c7fae54779e4c579eb4a964c",
        "d91767c04e4c188b7ce58b87ac61fc8b",
        "c703649c542da6618d4abb5f8a298cd8"],
        "19212ce1594f3ec723861bfab9c39640"),
    "sr-intra-hbd": ([
        "18e33b1c9c1c9d7e8443a810ce7d0bbd",
        "2c72d5b42bddf22860faa7734360fb3d"],
        "282f09611258ede5b7dee9d8f974a6a3"),
    "i422-superres": ([
        "3b5440539cd073a2ac90c5fa3d71968d",
        "da4e225c30754da6e37be8b622bc4d5d",
        "73f483814b3ccf95fd9579cd29a574ff"],
        "5782b6c68a97387734a3cfaa3882fe61"),
    "mono-superres": ([
        "c948fb54d1e55b40d208fc59cb2a9cbf",
        "b602d1d735ac0f9c3418cef2b572cb6a",
        "308a51d219fc85e39771ef239223a15b"],
        "3df4c90541ddeb6470af0ac1bc53557d"),
    "fg-inter": ([
        "00da17c7e43f86e7b60252c1edd2def4",
        "2f9e69ea0294a308cfe6ad4330488ef6",
        "bb010c79042ac1ef6fc31584ae3759b3"],
        "4b3b85edee7aaa37d2b37e4b84e9e61e"),
    "fg-chroma-from-luma": ([
        "5eca441b4a8eeae90c6d99f6d62456ae",
        "699a656bfa23191a16a3622002aa5aa7"],
        "5e9a96ec8dbc1f6470ff945a0c7c3239"),
    "fg-lag3": ([
        "1f250e67f1bbcda5d730f9005d24efa9",
        "87a96317c2b6410274d374dd26fc2538"],
        "756c2491041048116e8ef6234ba03f61"),
    "i420-12b-grain": ([
        "fada4c22fabe0a4ea8ce992b46994303",
        "befed020d68fdcd37be70a651d249744"],
        "ab610d74ebe459f3d4812519d0a58fb6"),
    "i444-grain": ([
        "9012240a4d0c31012be3f4be209780d2",
        "67f6f37aa825538248a5d6b7716181b1"],
        "f597be5d8e5655fb4742b55e39f36d60")}
# the 1080p super-res and film grain streams of the phases of their
# names (tests/torch_port_cases.py BIG_POST_FILTERS: 2 intra frames
# each, every in-loop filter on; sr-1080p coded 960 wide), committed
# under GOLDEN_DIR, and their md5s by the same recipe (dav1d_tpu's
# golden numpy path, grain applied)
BIG_POST_FILTERS = {
    "sr-1080p": ([
        "366f7fb3e9e91bd85a8255efc75d6a3a",
        "f9f27c966bd5db5933eb4a6d6c89e284"],
        "42028cf6a5b97f0e450229bfa22a5c60"),
    "fg-1080p": ([
        "1ab208c59cfaef3971c1473000dda149",
        "53aa9c198de5b0f11327ba629788fa28"],
        "02c90958a8139dd72805d4007d1af29d"),
    "fg-1080p-10b": ([
        "30047250a6628f71f575a778c05edbcd",
        "37b401d960f8b38484d601c444cfc9e6"],
        "7f2ad11159b13f62a4c68705e1bb6847")}
# the intra-leftover streams of the leftovers phase (tests/
# torch_port_cases.py LO_STREAMS: the configs of tests/test_lo_device.py),
# committed under GOLDEN_DIR: per picture and over the stream, the md5s
# of dav1d_tpu's golden numpy path (the recipe of MD5S_S7)
LO_STREAMS = {
    "lo-base": ([
        "c906785a93e8a9d93b24337f8c7b3641",
        "92ab5684d1e68404bdec59009d66532c",
        "bc942e38bcc6ee6d25ad22adfc51d091",
        "85aa2c2eadf36d6313feafe454fb4b46",
        "e42f587f345ff1c16aac054ddc83711a"],
        "5e87399e27bd981cb785061d8250501a"),
    "lo-dense": ([
        "beca61e863abb95d3b252c43c4b45584",
        "594899087e2954d972cfadd0ad703dfe",
        "a65f4cca26e3f68acea1162ce2958799",
        "c31c2ffbb48315ea186ad4c3d7616456",
        "ea6dd5a7d1d3ac31d6e03291a61e6ada"],
        "cf10ca2b761b2df9f1d5763b076723af"),
    "lo-444": ([
        "59f99a8daec927c475d0403ab3b1aa67",
        "6235cc095c44c6aa248d0aae9158e7f8",
        "959d9a4e2b9707bdaeaf8cf822ec50b6",
        "7887fb85b3c062fc447772ea1e661dc0"],
        "e69b1feff882fbbecbd43067e12f91a1"),
    "lo-422-hbd": ([
        "be9566fec58caae6b2952aa39bfee7b6",
        "4fda2ce8778d3955fa296741cfc9d7a0",
        "926d6e6e40a0719c2aa68091587ebcfe",
        "b72e1c5e82c74978e95e1bc7bae6c703"],
        "da547a124006071b45d7f68eaa101e8e"),
    "lo-multitile": ([
        "88be97e22317daceb314947a2b85a1e3",
        "cf84a97dd9f9bed7d52e9d8fea6ed19b",
        "9cc350126feb60d38acc2a15818765b6",
        "3ed1498a87d35d35e6e920c77b807d2a"],
        "2503f1161c70844b20fd4a8a95cf8ec2")}
# the mesh streams (tests/torch_port_cases.py MESH_STREAMS, committed
# under GOLDEN_DIR): dav1d_tpu's single_device_md5 of each, equal to its
# golden numpy path's (tools/torch_mesh_md5s.py)
MESH_MD5S = {
    "mesh-rich-256x128": "e58bd925214ebb07514cf2030a08a6fb",
    "mesh-inter-256x128": "a994827964462d5ed40d03700766e0ba",
    "mesh-superres-192x96": "a7dbabe6b32a4b54ff0eeee1492d2f5c",
}
KERNELS = ("deblock", "mc_put", "mc_comp", "itx_add", "mc_warp", "mc_obmc",
           "cdef", "lr_wiener", "lr_sgr", "superres", "film_grain", "ipred")
# the in-loop filter kernels after the deblock; every stream phase's
# stream runs all three (counted on the CPU: every s7, s11, s31 and s33
# frame, the keyframes included, has CDEF and both Wiener and SGR units)
FILTER_KERNELS = KERNELS[6:9]
# the kernels of the s31 main path (neither super-res nor film grain)
MAIN_KERNELS = KERNELS[:9]
# the kernels an inter stream without warp or OBMC (s7, s11) launches
KERNELS_NO_WARP = KERNELS[:4] + FILTER_KERNELS
# the CUDA kernels' names in a profiler trace, per wrapper
KERNEL_NAMES = {"deblock": ("deblock_",), "mc_put": ("mc_put_kernel",),
                "mc_comp": ("mc_comp_kernel",),
                "itx_add": ("itx_add_kernel", "itx_wht_kernel"),
                "mc_warp": ("mc_warp_kernel",),
                "mc_obmc": ("mc_obmc_kernel",), "cdef": ("cdef_kernel",),
                "lr_wiener": ("lr_wiener_kernel",),
                "lr_sgr": ("lr_sgr_kernel",),
                "superres": ("superres_kernel",),
                "film_grain": ("film_grain_kernel",),
                "ipred": ("ipred_frame_kernel",)}

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 33.5e12       # half the 67 TFLOP/s fp32 non-tensor rate
# integer ops every (line, edge) thread spends on its filter decision
# (tap differences, compares, LUT math); the data-dependent filter
# arithmetic comes on top, so this bounds the op time from below
DEBLOCK_OPS_PER_EDGE_LINE = 60
# integer ops of the filters after the deblock, counted from their
# arithmetic (lower bounds): a CDEF-filtered pixel (12 taps of
# difference, abs, shift, threshold, min, sign and multiply-add, the
# min/max of the clamp), a CDEF direction search of an 8x8 block (8
# bins of 64 adds, 90 squares, the costs and compares); a Wiener output
# (7-tap horizontal and vertical multiply-adds, two roundings and
# clips); an SGR output (its share of the box3 and box5 sums of values
# and squares and of calc_ab, the 3x3 and 3-wide blends, the weights)
CDEF_OPS_PER_PX = 120
CDEF_OPS_PER_BLOCK = 800
WIENER_OPS_PER_PX = 40
SGR_OPS_PER_PX = 150
REPEATS = 5                     # untimed keyframe decodes (median)
INTER_REPEATS = 3               # untimed inter-stream decodes (median)


_T0 = time.perf_counter()


def emit(obj):
    """Print obj as one JSON line; a phase's line with t_s, the seconds
    since the script started, and, where it holds stage ms, the Stage-B
    depth of its decodes: utils.timing sums a stage over threads, so at
    a depth above 1 the Stage-B workers' stage ms overlap in time."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
        if any("stage" in k for k in obj):
            from dav1d_tpu_torch.decoder import stageb_depth
            obj["stage_ms_summed_over_threads_at_stageb_depth"] = \
                stageb_depth(0, False)
    print(json.dumps(obj), flush=True)


def smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def phase_device(torch):
    emit({"phase": "device", "nvidia_smi": smi(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "nvcc": shutil.which("nvcc") or
          ("/usr/local/cuda/bin/nvcc"
           if os.path.exists("/usr/local/cuda/bin/nvcc") else None),
          "ninja": shutil.which("ninja")})


def phase_build():
    from dav1d_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    make = subprocess.Popen(["make", "-C", os.path.join(ROOT, "native")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    built = cuda_build.build(list(KERNELS))
    t_cuda = time.perf_counter() - t0
    out, err = make.communicate()
    t_make = time.perf_counter() - t0
    if make.returncode != 0:
        raise RuntimeError(f"make -C native failed:\n{out}{err}")
    ptxas = {n: [ln.strip() for ln in built[n]["ptxas"].splitlines()
                 if "registers" in ln or "entry function" in ln or
                 "stack frame" in ln] for n in built}
    emit({"phase": "build", "native_make_s": t_make,
          "cuda_s": {n: built[n]["seconds"] for n in built},
          "cuda_wall_s": t_cuda, "ptxas": [ln for n in built
                                           for ln in ptxas[n]]})
    return ptxas


def _lf_inputs(rng, h4, w4, bd):
    """tests/test_lf_pallas.py recipe: flat-biased content, random
    per-edge class and level."""
    import numpy as np
    px_max = (1 << bd) - 1
    plane = rng.integers(0, px_max + 1, (4 * h4, 4 * w4)).astype(np.int32)
    flat = rng.integers(0, px_max + 1, (h4, w4))
    sel = rng.random((h4, w4)) < 0.5
    f4 = np.repeat(np.repeat(np.where(sel, flat, -1), 4, 0), 4, 1)
    plane = np.where(f4 >= 0,
                     np.clip(f4 + rng.integers(-2, 3, plane.shape),
                             0, px_max), plane).astype(np.int32)
    maps = []
    for _ in range(2):
        maps.append((rng.integers(-1, 3, (h4, w4)).astype(np.int8),
                     rng.integers(0, 64, (h4, w4)).astype(np.uint8)))
    return plane, maps


def _time_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_us(torch, fn, name, iters=10):
    """Mean device time (us) of the kernels whose name contains `name`
    over `iters` calls of fn, from torch.profiler; None when the
    profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if name in ev.key:
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0)
            total += t
            count += ev.count
    return total / count if count and total else None


def _deblock_bytes(h4, w4):
    # one directional pass run on its own (the two-pass design): the
    # int32 plane read and written, the two byte maps read, two LUTs
    return 8 * 16 * h4 * w4 + 2 * h4 * w4 + 2 * 64 * 4


def _deblock_frame_work(shapes):
    """(fused bytes, two-pass bytes, ops) of deblocking planes of (h4,
    w4) in both directions: fused, each int32 pixel read and written
    once, the four byte maps and the two LUTs read once; two-pass, the
    plane read and written by each pass (_deblock_bytes); ops, the
    decision of every (line, edge) of both passes."""
    fused = sum(8 * 16 * h4 * w4 + 4 * h4 * w4 for h4, w4 in shapes) + \
        2 * 64 * 4
    two = sum(2 * _deblock_bytes(h4, w4) for h4, w4 in shapes)
    ops = sum(2 * 4 * h4 * w4 for h4, w4 in shapes) * \
        DEBLOCK_OPS_PER_EDGE_LINE
    return fused, two, ops


def _device_window_us(torch, fn, iters=10):
    """Per call of fn, the device time (us) of every device activity in
    a profiled window (kernels, copies, memsets) and of the deblock
    kernels alone; None when the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None, None
    total = sum(e.time_range.elapsed_us() for e in evs)
    kern = sum(e.time_range.elapsed_us() for e in evs
               if "deblock_" in e.name)
    return total / iters, kern / iters


def deblock_frame_times(torch, fn, plain):
    """Times of deblocking one frame's planes on the card: fn(), the
    wrapper (CUDA events, ms), all device work it launches and the
    deblock kernels alone (torch.profiler, us), and plain(), the plain
    version (ms). A trace without the kernel is taken again, up to 3
    times; after that the device times are CUDA events' (`timer`): an
    upper bound, as they also span the wrapper's host work."""
    timer = "profiler"
    for _attempt in range(3):
        all_us, kern_us = _device_window_us(torch, fn)
        if kern_us:
            break
    else:
        timer = "events"
        all_us = kern_us = 1e3 * _time_ms(torch, fn)
    return {"wrapper_ms": _time_ms(torch, fn),
            "device_all_us": all_us, "kernel_device_us": kern_us,
            "plain_ms": _time_ms(torch, plain, iters=3), "timer": timer}


def phase_kernel(torch, card):
    import numpy as np
    from dav1d_tpu_torch.ops import lf
    from dav1d_tpu_torch.ops.lf_ref import calc_eih
    dev = torch.device("cuda")
    e, i = calc_eih(3)
    lut_e = torch.from_numpy(e.astype(np.int32)).to(dev)
    lut_i = torch.from_numpy(i.astype(np.int32)).to(dev)

    def planes(h4, w4, luma, bd, seed):
        rng = np.random.default_rng(seed)
        plane, maps = _lf_inputs(rng, h4, w4, bd)
        return (torch.from_numpy(plane).to(dev), luma,
                *[tuple(torch.from_numpy(a).to(dev) for a in m)
                  for m in maps])

    # small shapes, shapes whose 64x64 tiles end ragged at the right and
    # bottom, the 1080p and 4K planes
    small = [(16, 64), (8, 8), (20, 36), (36, 52), (41, 23)]
    shapes = {True: small + [(288, 480), (544, 960)],
              False: small + [(144, 240), (272, 480)]}
    n_cases = 0
    max_err = 0

    def check(got, want, what):
        nonlocal n_cases, max_err
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            max_err = max(max_err, int((g - w).abs().max()))
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:4].tolist()
                raise AssertionError(f"deblock kernel != plain: {what} at "
                                     f"{bad}")
        n_cases += 1

    for bd in (8, 10, 12):
        for luma in (True, False):
            for h4, w4 in shapes[luma]:
                ent = planes(h4, w4, luma, bd, bd * 100 + h4 + w4 + luma)
                P, _, vm, hm = ent
                for vert, (cls, L) in zip((True, False), (vm, hm)):
                    # the other direction's edges all inactive
                    off = (torch.full_like(cls, -1), L)
                    one = (P, luma, (cls, L) if vert else off,
                           off if vert else (cls, L))
                    check(lf.deblock_frame_cuda([one], lut_e, lut_i, bd),
                          [lf.deblock_pass_plain(P, cls, L, lut_e, lut_i,
                                                 bd, luma, vert)],
                          f"bd={bd} luma={luma} shape={(h4, w4)} "
                          f"vertical={vert}")
                check(lf.deblock_frame_cuda([ent], lut_e, lut_i, bd),
                      lf.deblock_frame_plain([ent], lut_e, lut_i, bd),
                      f"bd={bd} luma={luma} shape={(h4, w4)} both passes")
        # whole 4:2:0 frames, every plane in one launch
        for h4, w4 in ((288, 480), (544, 960), (36, 52)):
            ent = [planes(h4, w4, True, bd, bd + h4)] + \
                [planes(h4 // 2, w4 // 2, False, bd, bd + h4 + k)
                 for k in (1, 2)]
            check(lf.deblock_frame_cuda(ent, lut_e, lut_i, bd),
                  lf.deblock_frame_plain(ent, lut_e, lut_i, bd),
                  f"bd={bd} frame {(h4, w4)}")

    # one 1080p 8-bit 4:2:0 frame of random maps (75% of the positions
    # active)
    ent = [planes(288, 480, True, 8, 7), planes(144, 240, False, 8, 8),
           planes(144, 240, False, 8, 9)]
    t = deblock_frame_times(
        torch, lambda: lf.deblock_frame_cuda(ent, lut_e, lut_i, 8),
        lambda: lf.deblock_frame_plain(ent, lut_e, lut_i, 8))
    fused, two, ops = _deblock_frame_work([(288, 480), (144, 240),
                                           (144, 240)])
    bound_s = max(fused / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
    emit({"phase": "kernel", "card": card, "cases": n_cases,
          "max_abs_err": max_err, "equal": True,
          "frame_1080p": {**t, "launches": 1, "fused_bytes": fused,
                          "blocks_per_sm": lf._lib().deblock_blocks_per_sm(),
                          "two_pass_bytes": two, "ops": ops,
                          "bound_fused_us": bound_s * 1e6,
                          "bound_two_pass_us": two / HBM_BYTES_PER_S * 1e6,
                          "active_share": float(np.mean(
                              [(m[0] >= 0).float().mean().item()
                               for e_ in ent for m in e_[2:]]))}})
    # "ms": all device work of one 1080p 4:2:0 frame's deblock
    return {"max_abs_err": max_err, "ms": t["device_all_us"] / 1e3,
            "plain_ms": t["plain_ms"], "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if fused / HBM_BYTES_PER_S >=
            ops / INT32_OPS_PER_S else "operations"}


def _launch_dicts():
    from dav1d_tpu_torch.ops import cdef, fg, ipred, itx, lf, lr, mc, \
        superres
    return (lf.LAUNCHES, mc.LAUNCHES, itx.LAUNCHES, cdef.LAUNCHES,
            lr.LAUNCHES, superres.LAUNCHES, fg.LAUNCHES, ipred.LAUNCHES)


def _counts_reset():
    for d in _launch_dicts():
        for k in d:
            d[k] = 0


def _counts():
    return {k: v for d in _launch_dicts() for k, v in d.items()}


def _t(torch, a, dev):
    import numpy as np
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _check_equal(torch, got, want, what):
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:4].tolist()
        raise AssertionError(f"{what}: kernel != plain at {bad}")
    return err


def phase_kernel_mc(torch, card):
    """Synthetic put and compound cases: kernel vs plain, torch.equal."""
    import numpy as np
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import mc
    from dav1d_tpu_torch.ops.device import device_tables
    dev = torch.device("cuda")
    tb = device_tables(dev)
    errs = {"mc_put": 0, "mc_comp": 0}
    n_put = n_comp = 0
    for bd in (8, 10, 12):
        # every size and filter type, subpel and copy, twice; a table
        # whose classes (filtered and copy) end in ragged blocks: each
        # alone, then the three as the planes of one launch
        cases = [kc.put_case(bd, seed) for seed in (bd, bd + 100)] + \
            [kc.put_case(bd, bd + 200, sizes=kc.ragged_put_sizes())]
        args = {k: [] for k in ("kernel", "plain")}
        for pi, case in enumerate(cases):
            refs = [_t(torch, r, dev) for r in case["refs"]]
            for k in args:
                args[k].append((refs, torch.zeros(
                    case["dst_shape"], dtype=torch.int32, device=dev),
                    case["rh"], case["rw"]))
            got, want = (torch.zeros(case["dst_shape"], dtype=torch.int32,
                                     device=dev) for _ in range(2))
            jobs = _t(torch, case["jobs"], dev)
            mc.put_cuda(refs, jobs, got, case["rh"], case["rw"], bd)
            mc.put_plain(refs, jobs, want, case["rh"], case["rw"], bd,
                         tb["mc_filter_banks"])
            torch.cuda.synchronize()
            errs["mc_put"] = max(errs["mc_put"], _check_equal(
                torch, got, want, f"mc_put bd={bd} case {pi}"))
            n_put += len(case["jobs"])
        jobs = np.concatenate([c["jobs"] for c in cases])
        jobs[:, 0] = np.repeat(np.arange(3), [len(c["jobs"]) for c in cases])
        rows, blk = mc.put_blocks(jobs, group=jobs[:, 0])
        mc.put_planes_cuda(args["kernel"], _t(torch, rows, dev), bd,
                           _t(torch, blk, dev))
        mc.put_planes_plain(args["plain"], _t(torch, jobs, dev), bd,
                            tb["mc_filter_banks"])
        torch.cuda.synchronize()
        for pi, (a, b) in enumerate(zip(args["kernel"], args["plain"])):
            errs["mc_put"] = max(errs["mc_put"], _check_equal(
                torch, a[1], b[1], f"mc_put bd={bd} one launch, plane {pi}"))
        for ss, sizes in itertools.product(
                ((1, 1), (1, 0), (0, 0)), (None, kc.ragged_comp_sizes())):
            seed = bd + 3 * ss[0] + ss[1] + (50 if sizes else 0)
            case = kc.comp_case(bd, seed, *ss, sizes=sizes)
            outs = {}
            for name in ("kernel", "plain"):
                seg = torch.zeros(case["seg_shape"], dtype=torch.int32,
                                  device=dev)
                planes = []
                for sfx, luma in (("y", True), ("c", False)):
                    refs = [_t(torch, r, dev) for r in case[f"refs_{sfx}"]]
                    jobs = _t(torch, case[f"jobs_{sfx}"], dev)
                    plane = torch.zeros(case[f"dst_{sfx}"],
                                        dtype=torch.int32, device=dev)
                    rh, rw = case[f"bounds_{sfx}"]
                    if name == "kernel":
                        mc.comp_cuda(refs, jobs, plane, seg, rh, rw, bd,
                                     tb["mc_wedge_lut16"],
                                     tb["mc_wedge_lut32"], luma, *ss)
                    else:
                        mc.comp_plain(refs, jobs, plane, seg, rh, rw, bd,
                                      tb["mc_filter_banks"],
                                      tb["mc_wedge_lut16"],
                                      tb["mc_wedge_lut32"], luma, *ss)
                    planes.append(plane)
                outs[name] = planes + [seg]
            torch.cuda.synchronize()
            for what, a, b in zip(("luma", "chroma", "seg"), outs["kernel"],
                                  outs["plain"]):
                errs["mc_comp"] = max(errs["mc_comp"], _check_equal(
                    torch, a, b, f"mc_comp bd={bd} ss={ss} seed={seed} "
                    f"{what}"))
            n_comp += len(case["jobs_y"]) + len(case["jobs_c"])
    emit({"phase": "kernel_mc", "card": card, "put_jobs": n_put,
          "comp_jobs": n_comp, "max_abs_err": errs, "equal": True})
    return errs


def phase_kernel_itx(torch, card):
    """Synthetic residual cases: kernel vs plain, torch.equal."""
    from dav1d_tpu_torch.ops import itx
    from dav1d_tpu_torch.ops import kernel_cases as kc
    dev = torch.device("cuda")
    err = n = 0
    for bd in (8, 10, 12):
        cases = [(kc.itx_case(bd, seed), ("jobs", "wht"))
                 for seed in (bd, bd + 100)]
        cases.append((kc.itx_stress_case(bd, 20 + bd),
                      ("extreme", "ragged")))
        for case, tables in cases:
            pool = _t(torch, case["pool"], dev)
            for table in tables:
                wht = table == "wht"
                jobs = _t(torch, case[table], dev)
                got = _t(torch, case["plane"], dev)
                want = got.clone()
                itx.itx_add_cuda(pool, jobs, got, bd, wht=wht)
                itx.itx_add_plain(pool, jobs, want, bd, wht=wht)
                torch.cuda.synchronize()
                err = max(err, _check_equal(
                    torch, got, want, f"itx_add bd={bd} table={table}"))
                n += len(jobs)
    emit({"phase": "kernel_itx", "card": card, "jobs": n,
          "max_abs_err": err, "equal": True})
    return err


def phase_kernel_warp_obmc(torch, card):
    """Synthetic warp and OBMC cases: kernel vs plain, torch.equal."""
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import mc_obmc, mc_warp
    from dav1d_tpu_torch.ops.device import device_tables
    dev = torch.device("cuda")
    tb = device_tables(dev)
    errs = {"mc_warp": 0, "mc_obmc": 0}
    n_warp = n_lap = 0
    for bd, ss in itertools.product((8, 10, 12), ((1, 1), (1, 0), (0, 0))):
        seed = bd + 3 * ss[0] + ss[1]
        case = kc.warp_case(bd, seed, *ss)
        # the whole table (its last block of 8 warps full), then one cut
        # to end its last block ragged
        for cut in (None, -5):
            jobs = _t(torch, case["jobs"][:cut], dev)
            got, want = (kc.case_planes(case, dev) for _ in range(2))
            mc_warp.warp_cuda(got, jobs, bd)
            mc_warp.warp_planes_plain(want, jobs, bd, tb["mc_warp_filter"])
            torch.cuda.synchronize()
            for pi, (g, w) in enumerate(zip(got, want)):
                errs["mc_warp"] = max(errs["mc_warp"], _check_equal(
                    torch, g[1], w[1], f"mc_warp bd={bd} ss={ss} "
                    f"cut={cut} plane {pi}"))
            n_warp += len(jobs)
        case = kc.obmc_case(bd, seed, *ss)
        # the whole tables, then counts that are not multiples of 3
        for cut in ((None, None), (-1, -2)):
            got, want = (kc.case_planes(case, dev) for _ in range(2))
            top, left = (_t(torch, case[k][:c], dev)
                         for k, c in zip(("top", "left"), cut))
            mc_obmc.obmc_cuda(got, top, left, bd)
            mc_obmc.obmc_frame_plain(want, top, left, bd,
                                     tb["mc_filter_banks"],
                                     tb["mc_obmc_masks"])
            n_lap += len(top) + len(left)
            torch.cuda.synchronize()
            for pi, (g, w) in enumerate(zip(got, want)):
                errs["mc_obmc"] = max(errs["mc_obmc"], _check_equal(
                    torch, g[1], w[1], f"mc_obmc bd={bd} ss={ss} cut={cut} "
                    f"plane {pi}"))
    emit({"phase": "kernel_warp_obmc", "card": card, "warp_tiles": n_warp,
          "obmc_laps": n_lap, "max_abs_err": errs, "equal": True})
    return errs


def _filter_plain(torch, name, args):
    """The plain version of a CDEF / Wiener / SGR launch on `args` (the
    kernel wrapper's arguments; lr_wiener / lr_sgr: wiener_frame's /
    sgr_frame's): CDEF returns new planes, Wiener and SGR fresh copies
    of their destinations, filtered."""
    from dav1d_tpu_torch.ops import cdef, lr
    from dav1d_tpu_torch.ops.device import device_tables
    if name == "cdef":
        return cdef.cdef_planes_plain(
            *args, device_tables(args[0][0].device)["cdef_proj"])
    planes, tables, bd = args
    dsts = [p[2].clone() for p in planes]
    (lr.wiener_frame_plain if name == "lr_wiener" else lr.sgr_frame_plain)(
        [(s, q, d, w, h) for (s, q, _, w, h), d in zip(planes, dsts)],
        tables, bd)
    return dsts


def _filter_cuda(name, args, dst=None):
    """The kernel launch of a CDEF / Wiener / SGR call on `args`; Wiener
    and SGR write into dst (a list, a destination a plane; the args' own
    destinations by default)."""
    from dav1d_tpu_torch.ops import cdef, lr
    if name == "cdef":
        return cdef.cdef_cuda(*args)
    planes, tables, bd = args
    dsts = [p[2] for p in planes] if dst is None else dst
    (lr.wiener_frame_cuda if name == "lr_wiener" else lr.sgr_frame_cuda)(
        [(s, q, d, w, h) for (s, q, _, w, h), d in zip(planes, dsts)],
        tables, bd)
    return dsts


def _filter_check(torch, name, args, what):
    """Launch the kernel on args (Wiener / SGR into copies of their
    destinations) and hold it torch.equal to the plain version; returns
    the max abs error (0)."""
    want = _filter_plain(torch, name, args)
    got = _filter_cuda(name, args, None if name == "cdef" else
                       [p[2].clone() for p in args[0]])
    torch.cuda.synchronize()
    return max(_check_equal(torch, g, w, f"{what} plane {i}")
               for i, (g, w) in enumerate(zip(got, want)))


def phase_kernel_filters(torch, card):
    """Synthetic CDEF, Wiener and SGR cases: kernel vs plain,
    torch.equal."""
    from dav1d_tpu_torch.ops import kernel_cases as kc
    dev = torch.device("cuda")
    errs = {k: 0 for k in FILTER_KERNELS}
    n = {k: 0 for k in FILTER_KERNELS}
    for case in kc.cdef_cases():
        errs["cdef"] = max(errs["cdef"], _filter_check(
            torch, "cdef", kc.cdef_args(case, dev),
            f"cdef bd={case['bd']} layout={case['layout']} "
            f"crop={(case['Hy'], case['Wy'])}"))
        n["cdef"] += 1
    for case in kc.lr_cases():
        name = "lr_" + case["kind"]
        errs[name] = max(errs[name], _filter_check(
            torch, name, kc.frame_args(kc.lr_frame_case(case), dev,
                                       case["kind"]),
            f"{name} bd={case['bd']} wmax={case['wmax']} "
            f"hmax={case['hmax']}"))
        n[name] += len(case["items"])
    # the one-launch Wiener and SGR of a frame: planes of different
    # shapes
    frames = {}
    for kind in ("wiener", "sgr"):
        name = "lr_" + kind
        for case in kc.frame_cases(kind):
            args = kc.frame_args(case, dev, kind)
            errs[name] = max(errs[name], _filter_check(
                torch, name, args,
                f"{name} frame bd={case['bd']} layout={case['layout']}"))
            f = frames.setdefault(kind, [0, 0])
            f[0] += 1
            f[1] += len(args[1][0])
    emit({"phase": "kernel_filters", "card": card, "cdef_frames": n["cdef"],
          "wiener_items": n["lr_wiener"], "wiener_frames": frames["wiener"][0],
          "wiener_frame_items": frames["wiener"][1],
          "sgr_items": n["lr_sgr"], "sgr_frames": frames["sgr"][0],
          "sgr_frame_items": frames["sgr"][1],
          "max_abs_err": errs, "equal": True})
    return errs


def _cdef_work(torch, planes, maps, Hy, Wy, layout, bd, damping):
    """(bytes, ops) of a CDEF call: every pixel of its (padded) planes
    read and written once as int32, the maps read once; CDEF_OPS_PER_PX
    for each pixel of a block that filters (luma: apply and an adjusted
    primary or a secondary strength, as the plain version decides;
    chroma: apply and a strength) and CDEF_OPS_PER_BLOCK for each 8x8
    direction search."""
    from dav1d_tpu_torch.ops import cdef
    from dav1d_tpu_torch.ops.device import device_tables
    proj = device_tables(planes[0].device)["cdef_proj"]
    adj, _, _ = cdef.block_params_plain(planes[0][:Hy, :Wy], maps, layout,
                                        bd, proj)
    y_on = (maps[4] != 0) & ((adj != 0) | (maps[1] != 0))
    px = 64 * int(y_on.sum())
    if len(planes) > 1:
        uv_on = (maps[5] != 0) & ((maps[2] != 0) | (maps[3] != 0))
        px += 2 * (64 >> ((layout == 1) + (layout != 3))) * int(uv_on.sum())
    bytes_ = 8 * sum(p.numel() for p in planes) + 4 * maps.numel()
    return bytes_, px * CDEF_OPS_PER_PX + \
        (Hy // 8) * (Wy // 8) * CDEF_OPS_PER_BLOCK


def _lr_work(name, args):
    """(bytes, ops) of a frame's Wiener or SGR call (lr_wiener /
    lr_sgr: wiener_frame's / sgr_frame's arguments): each restored pixel
    read and written once as int32 and its tables read once, and
    WIENER_OPS_PER_PX / SGR_OPS_PER_PX per restored pixel. The tables
    count as one plane's call per plane had them, whatever the kernel's
    grouping: per item its row table of the plane's hmax + 6 entries,
    colbase, oy, ox, ohs, ows and Wiener's 14 taps or SGR's s0, s1, w0,
    w1, int32."""
    import numpy as np
    planes, (items, _), _ = args
    hmax = np.array([p[4] for p in planes], np.int64)[items[:, 0]]
    px = int((items[:, 4].astype(np.int64) * items[:, 5]).sum())
    if name == "lr_wiener":
        return 8 * px + 4 * int((hmax + 6 + 19).sum()), \
            px * WIENER_OPS_PER_PX
    return 8 * px + 4 * int((hmax + 6 + 9).sum()), px * SGR_OPS_PER_PX


def _warp_work(jobs, n_refs, ref_shape, rh, rw):
    """(bytes, ops) of a warp call over one plane's tiles, counted as
    _put_work counts a put: the distinct reference pixels the 15x15
    windows read, each 8x8 output written once and the job table; per
    tile 8 multiply-adds (2 ops each) for each of the 120 horizontal and
    64 vertical sums, and 8 ops per sum for its filter row, rounding and
    clip."""
    import numpy as np
    seen = np.zeros((n_refs, *ref_shape), bool)
    for j in np.asarray(jobs).tolist():
        slot, dy, dx = j[3], j[4] - 3, j[5] - 3
        seen[slot, min(max(dy, 0), rh - 1):min(max(dy + 14, 0), rh - 1) + 1,
             min(max(dx, 0), rw - 1):min(max(dx + 14, 0), rw - 1) + 1] = True
    n = len(jobs)
    return 4 * (int(seen.sum()) + 64 * n + np.asarray(jobs).size), \
        n * 184 * (16 + 8)


def _obmc_work(jobs, n_refs, ref_shape, rh, rw, top, dst_shape):
    """(bytes, ops) of an OBMC call over one plane's laps of one
    direction: the distinct reference pixels the windows of the blended
    region read, each blended pixel (cut at the plane) read and written
    once, and the job table; 2 ops per multiply-add of the two 8-tap
    passes, 4 for the roundings and clip and 5 for the blend, per
    pixel."""
    import numpy as np
    seen = np.zeros((n_refs, *ref_shape), bool)
    px = ops = 0
    H, W = dst_shape
    for j in np.asarray(jobs).tolist():
        ww, hh, py, pxx, slot, dy, dx = j[2], j[3], j[5], j[6], j[7], \
            j[8] - 3, j[9] - 3
        rows = min((hh * 3) >> 2 if top else hh, H - py)
        cols = min(ww if top else (ww * 3) >> 2, W - pxx)
        if rows <= 0 or cols <= 0:
            continue
        seen[slot,
             min(max(dy, 0), rh - 1):min(max(dy + rows + 6, 0), rh - 1) + 1,
             min(max(dx, 0), rw - 1):min(max(dx + cols + 6, 0), rw - 1) + 1
             ] = True
        px += rows * cols
        ops += 16 * ((rows + 7) * cols + rows * cols) + 9 * rows * cols
    return 4 * (int(seen.sum()) + 2 * px + np.asarray(jobs).size), ops


def _put_work(jobs, n_refs, ref_shape, rh, rw):
    """(bytes, ops) a put call must move / do: the distinct reference
    pixels its windows read (each once), each output pixel written once
    and the job table; 2 ops per multiply-add of the two 8-tap passes
    (bilinear: 2 taps) plus the two roundings and the clip. A job with
    amx = amy = 0 is a clamped copy: its h x w pixels, no ops."""
    import numpy as np
    seen = np.zeros((n_refs, *ref_shape), bool)
    ops = 0
    for j in np.asarray(jobs).tolist():
        h, w, slot, dy, dx, ft = j[1], j[2], j[5], j[6], j[7], j[10]
        copy = j[8] == 0 and j[9] == 0
        taps, off = (1, 0) if copy else (2, 0) if ft < 0 else (8, 3)
        # the window: rows y0 .. y0 + h + taps - 2, columns alike
        y0, x0 = dy - off, dx - off
        y1, x1 = y0 + h + taps - 2, x0 + w + taps - 2
        seen[slot, min(max(y0, 0), rh - 1):min(max(y1, 0), rh - 1) + 1,
             min(max(x0, 0), rw - 1):min(max(x1, 0), rw - 1) + 1] = True
        if not copy:
            ops += 2 * taps * ((h + taps - 1) * w + h * w) + 4 * h * w
    out = int(sum(j[1] * j[2] for j in np.asarray(jobs).tolist()))
    return 4 * (int(seen.sum()) + out + np.asarray(jobs).size), ops


def _comp_work(jobs, n_refs, ref_shape, rh, rw, luma, ss_hor, ss_ver):
    """(bytes, ops) of a compound call, counted as _put_work for both
    predictions, plus the seg plane's writes (luma seg jobs, at chroma
    size) or reads (chroma jobs with mkind 2) and 12 ops per pixel for
    the combine."""
    import numpy as np
    j = np.asarray(jobs)
    b0, o0 = _put_work(np.concatenate([j[:, :5], j[:, 18:19], j[:, 13:17],
                                       j[:, 17:18]], 1), n_refs,
                       ref_shape, rh, rw)
    b1, o1 = _put_work(np.concatenate([j[:, :5], j[:, 24:25], j[:, 19:23],
                                       j[:, 23:24]], 1), n_refs,
                       ref_shape, rh, rw)
    out = int((j[:, 1] * j[:, 2]).sum())
    # each prediction's count holds the output and an 11-column table
    # once: keep one output and the real 25-column table
    bytes_ = b0 + b1 - 4 * (out + 2 * len(j) * 11) + 4 * j.size
    if luma:
        seg = j[j[:, 5] == 3]
        seg_px = int(((seg[:, 1] >> ss_ver) * (seg[:, 2] >> ss_hor)).sum())
    else:
        seg = j[j[:, 8] == 2]
        seg_px = int((seg[:, 1] * seg[:, 2]).sum())
    return bytes_ + 4 * seg_px, o0 + o1 + 12 * out


def _itx_work(jobs, wht):
    """(bytes, ops) of a residual call: each coefficient read once, each
    pixel read and written once, the job table; ops: N log2 N adds per
    1-D transform of N points (the butterflies' additions alone, a lower
    bound) plus the add and clip."""
    import math
    import numpy as np
    from dav1d_tpu_torch.entropy import levels as lv
    from dav1d_tpu_torch.ops.itx import CF_LEN
    j = np.asarray(jobs)
    if wht:
        n = len(j)
        return 4 * (n * 16 * 3 + j.size), n * (16 * 2 * 8 + 16 * 2)
    bytes_ = ops = 0
    for tx in j[:, 0].tolist():
        t = lv.TXFM_INFO[tx]
        w, h = 4 * t.w, 4 * t.h
        bytes_ += 4 * (int(CF_LEN[tx]) + 2 * w * h)
        ops += min(h, 32) * w * int(math.log2(w)) + \
            w * h * int(math.log2(h)) + 2 * w * h
    return bytes_ + 4 * j.size, ops


def _bound(bytes_, ops):
    tb, to = bytes_ / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def _fresh(t):
    """A copy of a kernel input (a tensor, a list of them, or None)."""
    if t is None:
        return None
    return [x.clone() for x in t] if isinstance(t, list) else t.clone()


def _largest_block(name, blk):
    """The row of a put, compound or residual block table whose block
    covers the most pixels (filtered before copy puts)."""
    import numpy as np
    if name == "mc_put":
        c = blk[:, 0] % 25
        px = (2 << (c // 5)) * (2 << (c % 5)) * blk[:, 2] * \
            np.where(blk[:, 0] < 25, 2, 1)
    elif name == "mc_comp":
        px = (4 << (blk[:, 0] >> 2)) * (4 << (blk[:, 0] & 3)) * blk[:, 2]
    else:
        from dav1d_tpu_torch.entropy import levels as lv
        area = np.array([16 * t.w * t.h for t in lv.TXFM_INFO])
        px = area[blk[:, 0] >> 4] * blk[:, 2]
    return int(np.argmax(px))


def phase_kernel_real(torch, card, stream=STREAM_S7, md5s_want=MD5S_S7,
                      need=KERNELS_NO_WARP[1:]):
    """Decode the first 2 temporal units of `stream` on cuda with every
    put / warp / compound / OBMC / residual launch of its inter frame
    checked against the plain version on the same inputs, and the CDEF,
    Wiener and SGR launches of that frame recorded (each kernel of
    `need` launched); then hold the filter kernels to their plain
    versions on the recorded inputs, and time each kernel and its plain
    version on those inputs."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from dav1d_tpu_torch.ops import cdef, itx, lf, lr, mc, mc_obmc, mc_warp
    from dav1d_tpu_torch.ops.device import device_tables
    dev = torch.device("cuda")
    tb = device_tables(dev)
    calls = {"mc_put": [], "mc_comp": [], "itx_add": [], "mc_warp": [],
             "mc_obmc": [], **{k: [] for k in FILTER_KERNELS}}
    errs = {k: 0 for k in calls}
    orig = {"put_planes": mc.put_planes, "comp": mc.comp,
            "itx_add": itx.itx_add, "warp_planes": mc_warp.warp_planes,
            "obmc_planes": mc_obmc.obmc_planes,
            "deblock_frame": lf.deblock_frame,
            "cdef_planes": cdef.cdef_planes,
            "wiener_frame": lr.wiener_frame, "sgr_frame": lr.sgr_frame}
    label = os.path.basename(stream)

    def planes_plain(name, planes, jobs, bd):
        """The plain version of a put / warp / OBMC launch over
        `planes` (OBMC's jobs: its (top, left) tables)."""
        if name == "mc_put":
            return mc.put_planes_plain(planes, jobs, bd,
                                       tb["mc_filter_banks"])
        if name == "mc_warp":
            return mc_warp.warp_planes_plain(planes, jobs, bd,
                                             tb["mc_warp_filter"])
        return mc_obmc.obmc_frame_plain(planes, *jobs, bd,
                                        tb["mc_filter_banks"],
                                        tb["mc_obmc_masks"])

    def planes_spy(name, run):
        # a launch over a frame's planes: (planes, jobs, before, bd,
        # blocks); OBMC's jobs are its (top, left) tables, blocks the
        # put's table
        def spy(planes, jobs, *args, **kw):
            before = [p.clone() for _, p, _, _ in planes]
            run(planes, jobs, *args, **kw)
            if name == "mc_obmc":
                jobs, bd = (jobs, args[0]), args[1]
            else:
                bd = args[0]
            blocks = kw.get("blocks") if name == "mc_put" else None
            want = [(r, b.clone(), rh, rw)
                    for (r, _, rh, rw), b in zip(planes, before)]
            planes_plain(name, want, jobs, bd)
            for (_, p, _, _), (_, w, _, _) in zip(planes, want):
                errs[name] = max(errs[name], _check_equal(
                    torch, p, w, f"{name} on {label} tables"))
            calls[name].append((planes, jobs, before, bd, blocks))
            return [p for _, p, _, _ in planes]
        return spy

    frames = []

    def deblock_frame(entries, lut_e, lut_i, bd):
        frames.append((entries, lut_e, lut_i, bd))
        return orig["deblock_frame"](entries, lut_e, lut_i, bd)

    def comp(refs, jobs, plane, seg, rh, rw, bd, luma, ss_hor, ss_ver,
             blocks=None):
        before, seg_before = plane.clone(), seg.clone()
        orig["comp"](refs, jobs, plane, seg, rh, rw, bd, luma, ss_hor,
                     ss_ver, blocks)
        want, want_seg = before.clone(), seg_before.clone()
        mc.comp_plain(refs, jobs, want, want_seg, rh, rw, bd,
                      tb["mc_filter_banks"], tb["mc_wedge_lut16"],
                      tb["mc_wedge_lut32"], luma, ss_hor, ss_ver)
        for a, b in ((plane, want), (seg, want_seg)):
            errs["mc_comp"] = max(errs["mc_comp"], _check_equal(
                torch, a, b, f"mc_comp on {label} tables"))
        calls["mc_comp"].append((refs, jobs, before, seg_before, rh, rw,
                                 bd, luma, ss_hor, ss_ver, blocks))
        return plane

    def itx_add(pool, jobs, plane, bd, wht=False, blocks=None):
        before = plane.clone()
        orig["itx_add"](pool, jobs, plane, bd, wht, blocks)
        want = before.clone()
        itx.itx_add_plain(pool, jobs, want, bd, wht)
        errs["itx_add"] = max(errs["itx_add"], _check_equal(
            torch, plane, want, f"itx_add on {label} tables"))
        calls["itx_add"].append((pool, jobs, before, bd, wht, blocks))
        return plane

    # the filter launches, by frame (the deblock's count when they ran):
    # CDEF's arguments, and Wiener's and SGR's with a copy of their
    # destinations as they were before the launch
    filt = []

    def filter_spy(name, run):
        def spy(*a):
            if name == "cdef":
                rec = a
            else:
                rec = ([(s, q, d.clone(), w, h) for s, q, d, w, h in a[0]],
                       *a[1:])
            filt.append((len(frames), name, rec))
            return run(*a)
        return spy

    mc.put_planes = planes_spy("mc_put", orig["put_planes"])
    mc_warp.warp_planes = planes_spy("mc_warp", orig["warp_planes"])
    mc_obmc.obmc_planes = planes_spy("mc_obmc", orig["obmc_planes"])
    mc.comp, itx.itx_add = comp, itx_add
    lf.deblock_frame = deblock_frame
    cdef.cdef_planes = filter_spy("cdef", orig["cdef_planes"])
    lr.wiener_frame = filter_spy("lr_wiener", orig["wiener_frame"])
    lr.sgr_frame = filter_spy("lr_sgr", orig["sgr_frame"])
    try:
        _, digest, _, _, md5s = _decode(stream, timed=False, n_tu=2)
    finally:
        mc.put_planes, mc.comp, itx.itx_add = orig["put_planes"], \
            orig["comp"], orig["itx_add"]
        mc_warp.warp_planes = orig["warp_planes"]
        mc_obmc.obmc_planes = orig["obmc_planes"]
        lf.deblock_frame = orig["deblock_frame"]
        cdef.cdef_planes = orig["cdef_planes"]
        lr.wiener_frame, lr.sgr_frame = orig["wiener_frame"], \
            orig["sgr_frame"]
    if md5s != md5s_want[:2]:
        raise AssertionError(f"kernel_real {label}: md5s {md5s}")
    # the inter frame's filter launches, each held to its plain version
    for f, name, rec in filt:
        if f == len(frames):
            calls[name].append(rec)
            errs[name] = max(errs[name], _filter_check(
                torch, name, rec, f"{name} on {label} frame 1"))
    if not all(calls[k] for k in need):
        raise AssertionError(f"kernel_real {label}: a kernel had no "
                             f"launch: "
                             f"{ {k: len(v) for k, v in calls.items()} }")
    calls = {k: v for k, v in calls.items() if v}

    # each launch, given fresh copies of its inputs; with `largest`, each
    # put, compound and residual launch keeps only the block of its table
    # that covers the most pixels, and each warp launch its first tile
    def runners(name, plain, largest=False):
        out = []
        if name in FILTER_KERNELS:
            # CDEF writes fresh planes; Wiener and SGR into their
            # destinations, given fresh copies of them
            for c in calls[name]:
                if name == "cdef":
                    out.append((None, None, (
                        lambda p, s, c=c: _filter_plain(torch, "cdef", c))
                        if plain else (lambda p, s, c=c: _filter_cuda(
                            "cdef", c))))
                    continue

                def fn(p, s, c=c, plain=plain, name=name):
                    a = ([(*q[:2], d, *q[3:]) for q, d in zip(c[0], p)],
                         *c[1:])
                    return _filter_plain(torch, name, a) if plain \
                        else _filter_cuda(name, a)
                out.append(([p[2] for p in c[0]], None, fn))
            return out
        for c in calls[name]:
            if largest and name == "mc_warp":
                c = (c[0], c[1][:1], *c[2:])
            elif largest and c[-1] is not None:
                i = _largest_block(name, c[-1].cpu().numpy())
                c = (*c[:-1], c[-1][i:i + 1])
            if name in ("mc_put", "mc_warp", "mc_obmc"):
                def fn(ps, s, c=c, plain=plain, name=name):
                    args = [(r, p, rh, rw)
                            for (r, _, rh, rw), p in zip(c[0], ps)]
                    if plain:
                        return planes_plain(name, args, c[1], c[3])
                    if name == "mc_put":
                        return mc.put_planes_cuda(args, c[1], c[3], c[4])
                    if name == "mc_warp":
                        return mc_warp.warp_cuda(args, c[1], c[3])
                    return mc_obmc.obmc_cuda(args, *c[1], c[3])
                out.append((c[2], None, fn))
            elif name == "mc_comp":
                refs, jobs, before, segb, rh, rw, bd, luma, sh, sv, _ = c
                if plain:
                    fn = (lambda p, s, c=c: mc.comp_plain(
                        c[0], c[1], p, s, c[4], c[5], c[6],
                        tb["mc_filter_banks"], tb["mc_wedge_lut16"],
                        tb["mc_wedge_lut32"], c[7], c[8], c[9]))
                else:
                    fn = (lambda p, s, c=c: mc.comp_cuda(
                        c[0], c[1], p, s, c[4], c[5], c[6],
                        tb["mc_wedge_lut16"], tb["mc_wedge_lut32"], c[7],
                        c[8], c[9], c[10]))
                out.append((before, segb, fn))
            else:
                pool, jobs, before, bd, wht, _ = c
                out.append((before, None, (lambda p, s, c=c:
                            itx.itx_add_plain(c[0], c[1], p, c[3], c[4]))
                            if plain else (lambda p, s, c=c:
                            itx.itx_add_cuda(c[0], c[1], p, c[3], c[4],
                                             c[5]))))
        return out

    def event_rounds(name, plain, reps, largest=False):
        """`reps` rounds of the frame's launches on fresh copies, each
        the CUDA-event ms of every launch (one call, synchronized)."""
        rounds = []
        for _ in range(reps):
            row = []
            for before, segb, fn in runners(name, plain, largest):
                p, s = _fresh(before), _fresh(segb)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                a.record()
                fn(p, s)
                b.record()
                torch.cuda.synchronize()
                row.append(a.elapsed_time(b))
            rounds.append(row)
        return rounds

    def device_us(name, largest=False, floor=None):
        """(total, per launch) device us of one round of the frame's
        launches, from torch.profiler: median of the last `reps` of
        reps + 3 rounds (the trace may miss the first kernels: up to 2
        seen). A trace that holds fewer, or in which a launch reads
        below its floor (`floor`, us a launch: what it cannot beat), is
        taken again, up to 3 times. On the card whole traces have come
        back empty three times running, and a launch has read below the
        time of its work's first tile alone; after 3 such traces each
        launch is timed by CUDA events instead (median of `reps`
        rounds), noted in `timers` with what the last trace showed: an
        upper bound, as the pair also spans the wrapper's host work and
        uploads."""
        n = len(calls[name])
        floor = floor or [0.0] * n
        for _attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps + 3):
                    for before, segb, fn in runners(name, False, largest):
                        fn(_fresh(before), _fresh(segb))
                torch.cuda.synchronize()
            evs = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and any(k in e.name for k in names[name])),
                         key=lambda e: e.time_range.start)
            if len(evs) < reps * n:
                seen = f"profiler saw {len(evs)} kernels"
                continue
            evs = evs[len(evs) - reps * n:]
            per = [sorted(evs[r * n + i].time_range.elapsed_us()
                          for r in range(reps))[reps // 2] for i in range(n)]
            low = [i for i in range(n) if per[i] < floor[i]]
            if not low:
                return sum(per), per
            seen = (f"profiler read launch {low[0]} at {per[low[0]]} us, "
                    f"below its floor {floor[low[0]]} us")
        timers[f"{name}{' alone' if largest else ''}"] = f"events ({seen})"
        rounds = event_rounds(name, False, reps, largest)
        per = [1e3 * sorted(r[i] for r in rounds)[reps // 2]
               for i in range(n)]
        return sum(per), per

    def frame_ms(name, plain, reps):
        """Sum over the frame's launches of the CUDA-event time of one
        call on fresh copies; median of `reps` rounds."""
        return sorted(sum(r) for r in event_rounds(name, plain,
                                                   reps))[reps // 2]

    names = KERNEL_NAMES
    reps = 5
    res = {}
    timers = {}
    fill = _fill_us(torch)
    for name in calls:
        frame_ms(name, False, 1)                          # warm-up
        # a launch's floor: a one-element fill; for the kernels with job
        # tables also 0.9 of the profiled time of the launch cut to one
        # block of its table (put, compound, residual: the largest;
        # warp: the first tile), which the whole launch runs among its
        # other blocks (0.9 for the trace's jitter)
        floor = [fill or 0.0] * len(calls[name])
        alone = None
        if name in ("mc_put", "mc_comp", "itx_add", "mc_warp"):
            alone = device_us(name, True, floor)[1]
            if f"{name} alone" not in timers:
                floor = [max(f, 0.9 * a) for f, a in zip(floor, alone)]
        dev_us, per_launch = device_us(name, floor=floor)
        if not dev_us:
            raise RuntimeError(f"torch.profiler reported no device time "
                               f"for {name}")
        if name == "cdef":
            # one block per 64x64 luma tile of the padded luma plane
            extra = {"blocks_per_launch": [
                -(-c[0][0].shape[0] // 64) * -(-c[0][0].shape[1] // 64)
                for c in calls[name]]}
        elif name in ("lr_wiener", "lr_sgr"):
            # one block per item and tile of 64 output columns
            extra = {"blocks_per_launch": [
                len(lr.item_blocks(c[1][0])) for c in calls[name]]}
        elif name == "mc_warp":
            # a warp per tile, 8 a block, no block table
            extra = {"blocks_per_launch": [-(-len(c[1]) // 8)
                                           for c in calls[name]],
                     "tile_alone_us": alone}
        elif name == "mc_obmc":
            # a warp per lap, 3 a block, as many blocks as the card holds
            # at once (fewer for fewer laps), top laps then left laps
            lib = mc_obmc._lib()
            laps = [[0 if t is None else len(t) for t in c[1]]
                    for c in calls[name]]
            extra = {"laps_per_launch": laps,
                     "blocks_per_sm": lib.mc_obmc_blocks_per_sm(),
                     "blocks_per_launch": [lib.mc_obmc_grid(*n)
                                           for n in laps]}
        else:
            extra = {"blocks_per_launch": [len(c[-1])
                                           for c in calls[name]],
                     "largest_block_alone_us": alone}
        bytes_ = ops = 0
        for c in calls[name]:
            if name == "cdef":
                b, o = _cdef_work(torch, *c)
            elif name in ("lr_wiener", "lr_sgr"):
                b, o = _lr_work(name, c)
            elif name in ("mc_put", "mc_warp"):
                planes, jobs, before = c[:3]
                j = jobs.cpu().numpy()
                b = o = 0
                for pi, (refs, _, rh, rw) in enumerate(planes):
                    bp, op = (_put_work if name == "mc_put" else _warp_work)(
                        j[j[:, 0] == pi], len(refs), tuple(refs[0].shape),
                        rh, rw)
                    b, o = b + bp, o + op
            elif name == "mc_obmc":
                planes, jobs, before = c[:3]
                b = o = 0
                for top, t in zip((1, 0), jobs):
                    if t is None:
                        continue
                    j = t.cpu().numpy()
                    for pi, (refs, _, rh, rw) in enumerate(planes):
                        bp, op = _obmc_work(j[j[:, 1] == pi], len(refs),
                                            tuple(refs[0].shape), rh, rw, top,
                                            tuple(before[pi].shape))
                        b, o = b + bp, o + op
            elif name == "mc_comp":
                refs, jobs, before, segb, rh, rw, bd, luma, sh, sv, _ = c
                b, o = _comp_work(jobs.cpu().numpy(), len(refs),
                                  tuple(refs[0].shape), rh, rw, luma, sh,
                                  sv)
            else:
                b, o = _itx_work(c[1].cpu().numpy(), c[4])
            bytes_ += b
            ops += o
        bound_ms, bound_by = _bound(bytes_, ops)
        res[name] = {
            "launches_per_frame": len(calls[name]),
            # filters: 8x8 luma blocks (CDEF), items (Wiener, SGR); OBMC
            # laps of both directions
            "jobs_per_frame": int(sum(
                c[1].shape[1] * c[1].shape[2] if name == "cdef" else
                len(c[1][0]) if name in FILTER_KERNELS else
                sum(len(t) for t in c[1] if t is not None)
                if name == "mc_obmc" else len(c[1])
                for c in calls[name])),
            "max_abs_err": errs[name],
            "ms": dev_us / 1e3, "launch_us": per_launch, **extra,
            "wrapper_ms": frame_ms(name, False, reps),
            "plain_ms": frame_ms(name, True, 3),
            "bytes": bytes_, "ops": ops, "bound_ms": bound_ms,
            "bound_by": bound_by}
    # the deblock of the inter frame's planes and maps, as the decode
    # sent them to the kernel
    entries, lut_e, lut_i, bd = frames[-1]
    got = lf.deblock_frame_cuda(entries, lut_e, lut_i, bd)
    err = max(_check_equal(torch, g, w, f"deblock on {label} frame 1")
              for g, w in zip(got, lf.deblock_frame_plain(entries, lut_e,
                                                          lut_i, bd)))
    fused, two, ops = _deblock_frame_work(
        [(e[0].shape[0] // 4, e[0].shape[1] // 4) for e in entries])
    deblock_real = {
        **deblock_frame_times(
            torch, lambda: lf.deblock_frame_cuda(entries, lut_e, lut_i, bd),
            lambda: lf.deblock_frame_plain(entries, lut_e, lut_i, bd)),
        "max_abs_err": err, "launches": 1,
        "active_share": [[float((m[0] >= 0).float().mean()) for m in e[2:]]
                         for e in entries],
        "bound_fused_us": max(fused / HBM_BYTES_PER_S,
                              ops / INT32_OPS_PER_S) * 1e6,
        "bound_two_pass_us": two / HBM_BYTES_PER_S * 1e6}
    emit({"phase": "kernel_real", "card": card, "stream": stream,
          "temporal_unit": 1, "md5s": md5s, "equal": True,
          "one_element_fill_us": fill, "kernels": res,
          "device_timers": timers or "profiler", "deblock": deblock_real,
          "library_ms": "null: no single PyTorch call computes a "
          "clamped-window 8-tap put, an affine-warped 8x8 tile, a masked "
          "compound, an OBMC lap blend, an integer AV1 inverse "
          "transform, a CDEF direction search and constrained filter, a "
          "Wiener filter over row-table windows or a self-guided filter"})
    return res


def _decode(path, timed, frame_type=None, n_tu=None, n_threads=0,
            mesh=None, max_frame_delay=0, feed_ahead=False, depths=None):
    """Decode `path` (its first n_tu temporal units; keyframes only
    with frame_type=3; n_threads and max_frame_delay as Settings takes
    them; column-sharded over `mesh` when given) on cuda through the
    public API, the pictures drained after each temporal unit is sent
    (the CLI's loop), or with feed_ahead after every unit is sent
    (bench.py's loop: only then can api.get_picture parse ahead while
    earlier frames are in Stage B); returns (pictures, stream md5, wall
    ms, stage ms, per-picture md5s). Stage ms are sums over threads:
    the Stage-B workers' stages overlap at a Stage-B depth above 1.
    `depths`, a list, is given the Stage-B depth of the decoder's
    pipeline (None without one)."""
    import torch
    from dav1d_tpu_torch.api import Decoder, Settings
    from dav1d_tpu_torch.bitstream.ivf import IvfReader
    from dav1d_tpu_torch.utils import timing
    from dav1d_tpu_torch.utils.muxers import Md5Muxer
    data = open(os.path.join(ROOT, path), "rb").read()
    timing.reset()
    timing.ENABLED = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    settings = Settings(n_threads=n_threads, sharding_mesh=mesh,
                        max_frame_delay=max_frame_delay) \
        if frame_type is None else \
        Settings(decode_frame_type=frame_type, n_threads=n_threads,
                 sharding_mesh=mesh, max_frame_delay=max_frame_delay)
    dec = Decoder(settings)
    mux = Md5Muxer()
    pics, md5s = [], []

    def drain():
        for pic in dec.pictures():
            mux.write_picture(pic)
            one = Md5Muxer()
            one.write_picture(pic)
            md5s.append(one.digest())
            pics.append(pic)
    for i, fr in enumerate(IvfReader(data)):
        if n_tu is not None and i >= n_tu:
            break
        dec.send_data(fr.data)
        if not feed_ahead:
            drain()
    drain()
    if depths is not None:
        pipe = dec._dec.pipeline
        depths.append(pipe.depth if pipe is not None else None)
    dec.close()
    wall = (time.perf_counter() - t0) * 1e3
    stages = {k: v * 1e3 for k, v in timing._T.items()}
    timing.ENABLED = False
    return pics, mux.digest(), wall, stages, md5s


def _profiled(torch, path, **kw):
    """One profiled (untimed) decode: the summed duration of the device
    activities (kernels, copies, memsets), each kernel's device ms, and
    the decode's wall ms and md5."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, digest, wall, _, _ = _decode(path, timed=False, **kw)
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    per = {}
    for ev in prof.key_averages():
        for name, keys in KERNEL_NAMES.items():
            if any(k in ev.key for k in keys):
                t = getattr(ev, "device_time_total", None)
                per[name] = per.get(name, 0.0) + (
                    t if t is not None else getattr(ev, "cuda_time_total",
                                                    0)) / 1e3
    return digest, busy_us / 1e3, wall, per


# the CPU events of the CUDA API calls that start device work
RUNTIME_CALLS = ("Launch", "Memcpy", "Memset")


def _credit(ranges, runtime, device):
    """Device ms credited to each range: ranges [(label, start, end)] on
    the host clock, runtime {correlation id: host start} of the runtime
    calls, device [(correlation id, start, end)] of the device activity.
    An activity whose id a runtime call has is credited to every range
    whose window holds that call's start (host clock against host
    clock); one that no runtime call in the trace owns, to every range
    whose window holds its own (start, end) (device clock against host
    clock, as before correlation). Returns ([ms per range], {"correlated":
    n, "by_window": n}) with the activities counted by how they were
    credited."""
    import bisect
    order = sorted(range(len(ranges)), key=lambda i: ranges[i][1])
    starts = [ranges[i][1] for i in order]
    ms = [0.0] * len(ranges)
    how = {"correlated": 0, "by_window": 0}
    for cid, a, b in device:
        t = runtime.get(cid)
        key = "correlated" if t is not None else "by_window"
        how[key] += 1
        for k in order[:bisect.bisect_right(starts, a if t is None else t)]:
            _, r0, r1 = ranges[k]
            if (t is not None and t <= r1) or (t is None and b <= r1):
                ms[k] += (b - a) / 1e3
    return ms, how


def _stage_device(torch, path, **kw):
    """One more profiled decode, synchronous (Settings(n_threads=1):
    every stage on the calling thread, where the profiler sees its
    ranges): the device ms of the work each stage (utils.timing phase)
    and each LR filter (lr.wiener, lr.sgr) launched, from
    record_function ranges set up around them here and taken away
    after, each ending in a device synchronize. A range's work is the
    device activity (kernels, copies, memsets) of the runtime calls the
    host made inside the range (_credit: by correlation id; the ranges'
    own device_time_total misses the kernels that ctypes launches, which
    no aten op owns). Returns the decode's md5; the device ms per label;
    the bytes each LR filter must move (the pixels it restores, int32,
    read and written once, and its unit tables, as _lr_work counts
    them); per label the ranges in which a kernel of the port launched
    (its launch count moved) but no device time was credited, beside
    how the device activity was credited; and per label the CUDA-event
    ms of its ranges (an event recorded as each range begins, one after
    its synchronize: an upper bound of its device time, as the pair
    also spans the host's work inside the range)."""
    from contextlib import contextmanager
    from torch.profiler import ProfilerActivity, profile, record_function
    from dav1d_tpu_torch.ops import lr
    from dav1d_tpu_torch.utils import timing
    orig = {"phase": timing.phase, "wiener": lr.wiener_frame,
            "sgr": lr.sgr_frame}
    labels = set()
    lr_bytes = {"lr.wiener": 0, "lr.sgr": 0}
    launched = {}       # label: launches inside each of its ranges
    events_ms = {}

    def total():
        return sum(_counts().values())

    @contextmanager
    def span(label):
        labels.add(label)
        n0 = total()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        with record_function(label):
            yield
            torch.cuda.synchronize()
        b.record()
        b.synchronize()
        launched.setdefault(label, []).append(total() - n0)
        events_ms[label] = events_ms.get(label, 0.0) + a.elapsed_time(b)

    @contextmanager
    def phase(label):
        with span(label), orig["phase"](label):
            yield

    def annotate(label, fn, name):
        def run(*a, **k):
            lr_bytes[label] += _lr_work(name, a)[0]
            with span(label):
                return fn(*a, **k)
        return run
    timing.phase = phase
    lr.wiener_frame = annotate("lr.wiener", orig["wiener"], "lr_wiener")
    lr.sgr_frame = annotate("lr.sgr", orig["sgr"], "lr_sgr")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, digest, _, _, _ = _decode(path, timed=False, n_threads=1,
                                         **kw)
    finally:
        timing.phase = orig["phase"]
        lr.wiener_frame, lr.sgr_frame = orig["wiener"], orig["sgr"]
    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.events())
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in evs
                     if e.device_type != cuda and e.name in labels),
                    key=lambda r: r[1])
    runtime = {e.id: e.time_range.start for e in evs
               if e.device_type != cuda and e.name.startswith("cu") and
               any(k in e.name for k in RUNTIME_CALLS)}
    # the device activity, without the spans that mirror the ranges on
    # the device timeline (they carry the ranges' names)
    device = [(e.id, e.time_range.start, e.time_range.end) for e in evs
              if e.device_type == cuda and e.name not in labels]
    ms, how = _credit(ranges, runtime, device)
    stage, seen = {}, {}
    for (label, _, _), m in zip(ranges, ms):
        stage[label] = stage.get(label, 0.0) + m
        seen.setdefault(label, []).append(m)
    # ranges (in the order they began, as the launch counts were taken)
    # in which a kernel launched and nothing was credited
    misses = {}
    for label, n in launched.items():
        got = seen.get(label, [])
        if len(got) != len(n):
            misses[label] = f"{len(got)} ranges traced of {len(n)}"
            continue
        k = sum(1 for a, m in zip(n, got) if a and not m)
        if k:
            misses[label] = k
    return digest, stage, lr_bytes, {"misses": misses, "credited": how,
                                     "runtime_calls": len(runtime)}, \
        events_ms


def _filter_bounds(pic, n_pics, lr_bytes):
    """Least device ms per picture of CDEF, Wiener and SGR: the bytes
    each must move over the HBM rate. CDEF: every pixel of the frame's
    planes read and written once as int32, and an int32 direction and
    strength per 8x8 luma block; Wiener / SGR: what lr_bytes counted in
    the profiled decode, per picture."""
    w, h = pic.w, pic.h
    px = w * h
    if pic.layout:
        px += 2 * ((w + pic.ss_hor) >> pic.ss_hor) * \
            ((h + pic.ss_ver) >> pic.ss_ver)
    cdef = 8 * px + 8 * ((w + 7) >> 3) * ((h + 7) >> 3)
    out = {"cdef": cdef / HBM_BYTES_PER_S * 1e3}
    for k, v in lr_bytes.items():
        out[k.split(".")[1]] = v / n_pics / HBM_BYTES_PER_S * 1e3
    return out


def phase_stream(torch, name, path, md5, shape, dtype, pic_md5s=None,
                 need=("deblock",), repeats=REPEATS, **kw):
    """Decode a stream on cuda through the public API: md5s, launch
    counts of the counted run (each kernel in `need` > 0), stage ms,
    untimed walls and the device idle share of one profiled decode."""
    # first decode warms the device (allocator, library handles)
    _, _, wall_first, _, _ = _decode(path, timed=False, **kw)
    _counts_reset()
    # the grain LUTs' memo cold: stage fg.luts is their host generation
    from dav1d_tpu_torch.ops import fg
    fg._DEVICE_CACHE.clear()
    pics, digest, wall_timed, stages, md5s = _decode(path, timed=True, **kw)
    launches = _counts()
    n_pics = len(pic_md5s) if pic_md5s else 1
    if len(pics) != n_pics:
        raise AssertionError(f"{name}: {len(pics)} pictures, expected "
                             f"{n_pics}")
    y = pics[0].planes[0]
    import numpy as np
    if y.shape != shape or y.dtype != np.dtype(dtype):
        raise AssertionError(f"{name}: luma {y.shape} {y.dtype}")
    if pic_md5s and md5s != pic_md5s:
        raise AssertionError(f"{name}: picture md5s {md5s} != {pic_md5s}")
    if digest != md5:
        raise AssertionError(f"{name}: md5 {digest} != {md5}")
    for k in need:
        if launches[k] == 0:
            raise AssertionError(f"{name}: the {k} kernel never launched")
    walls = []
    for _ in range(repeats):
        _, d2, wall, _, _ = _decode(path, timed=False, **kw)
        if d2 != md5:
            raise AssertionError(f"{name}: md5 {d2} on a repeat decode")
        walls.append(wall)
    d3, busy_ms, prof_wall, kernel_ms = _profiled(torch, path, **kw)
    if d3 != md5:
        raise AssertionError(f"{name}: md5 {d3} in the profiled decode")
    # a trace that credits nothing to a range in which a kernel
    # launched is taken again, up to 3 times; then each stage's device
    # ms are its CUDA-event ms (an upper bound), noted in its `timer`
    for _attempt in range(3):
        d4, stage_dev, lr_bytes, credit, events_ms = _stage_device(
            torch, path, **kw)
        if d4 != md5:
            raise AssertionError(f"{name}: md5 {d4} in the synchronous "
                                 f"profiled decode")
        if not credit["misses"]:
            credit["timer"] = "profiler"
            break
    else:
        stage_dev = events_ms
        credit["timer"] = "events"
    emit({"phase": name, "stream": path, "md5": digest, "pictures": n_pics,
          "luma_shape": list(y.shape), "launches": launches,
          "first_wall_ms": wall_first, "synced_wall_ms": wall_timed,
          "stage_ms": stages,
          "wall_ms": walls, "wall_ms_median": sorted(walls)[repeats // 2],
          "wall_ms_min": min(walls), "wall_ms_max": max(walls),
          "fps_median": 1e3 * n_pics / sorted(walls)[repeats // 2],
          "profiled_wall_ms": prof_wall, "device_busy_ms": busy_ms,
          "device_idle_share": 1 - busy_ms / prof_wall,
          "kernel_device_ms": kernel_ms, "stage_device_ms": stage_dev,
          "stage_device_credit": credit,
          "filter_bound_ms_per_picture": _filter_bounds(pics[0], n_pics,
                                                        lr_bytes)})
    return launches


def phase_golden_walks(torch):
    """Decode the GOLDEN_WALKS streams on cuda through the public API:
    picture and stream md5s, the launch counts of each run, and the
    walks it took (leftover blocks of inter frames replayed through the
    golden inter walk; intrabc frames through reconstruct_inter_frame):
    i444-intrabc's frames through reconstruct_inter_frame, every other
    stream's leftovers through the golden inter walk."""
    from dav1d_tpu_torch.recon import inter_device, inter_ref
    cls = inter_device.DeviceInterReconstructor
    run_b, run_f = cls._recon_b_inter, inter_ref.reconstruct_inter_frame
    walks = {}

    def leftover(self, *a):
        walks["leftover_blocks"] += 1
        return run_b(self, *a)

    def intrabc(*a):
        walks["intrabc_frames"] += 1
        return run_f(*a)
    cls._recon_b_inter, inter_ref.reconstruct_inter_frame = leftover, intrabc
    try:
        for name, (pic_md5s, md5) in GOLDEN_WALKS.items():
            walks.update(leftover_blocks=0, intrabc_frames=0)
            _counts_reset()
            pics, digest, wall, _, md5s = _decode(
                f"{GOLDEN_DIR}/{name}.ivf", timed=False)
            launches = _counts()
            if md5s != pic_md5s or digest != md5:
                raise AssertionError(f"golden_walks {name}: md5s {md5s} "
                                     f"{digest} != {pic_md5s} {md5}")
            walk = "intrabc_frames" if name == "i444-intrabc" \
                else "leftover_blocks"
            if not walks[walk]:
                raise AssertionError(f"golden_walks {name}: no {walk} "
                                     f"through the golden walk")
            emit({"phase": "golden_walks", "stream": name, "md5": digest,
                  "pictures": len(pics), **walks, "wall_ms": wall,
                  "launches": {k: v for k, v in launches.items() if v}})
    finally:
        cls._recon_b_inter, inter_ref.reconstruct_inter_frame = run_b, run_f


def _fill_us(torch):
    """Median device us of a one-element fill: what a launch of next to
    no work reads in a trace (None if the trace came back empty)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.empty(1, dtype=torch.int32, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(21):
            x.fill_(i)
        torch.cuda.synchronize()
    ts = sorted(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return ts[len(ts) // 2] if ts else None


def _launch_us(torch, fn, name, floor, rounds=1, n=5):
    """The device time (us) of one launch of the kernel whose name
    contains `name`: in each of `rounds` torch.profiler traces the
    median over n calls of fn; the median over the traces, and each
    trace's. A trace without the kernel, or whose median reads below
    `floor` (a one-element fill's launch: what no launch can beat), is
    taken again, up to 3 times; then that round's time is CUDA events'
    per call (an upper bound: it spans the wrapper's host work too).
    Returns (us, [us per round], timer)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    per, timer = [], "profiler"
    for _ in range(rounds):
        for _attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            d = sorted(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == cuda and name in e.name)
            if d and d[len(d) // 2] >= (floor or 0.0):
                per.append(d[len(d) // 2])
                break
        else:
            per.append(1e3 * _time_ms(torch, fn, iters=n))
            timer = "events"
    return sorted(per)[len(per) // 2], per, timer


# the cases of kernel_superres_grain that are timed, the main path's
# shape first (sr-1080p: 4:2:0 8-bit from 960 columns; fg-1080p: 4:2:0
# 8-bit with overlap), then monochrome and 4:4:4 and the other depths;
# (bd, layout, source width) and (bd, layout, overlap). The main shapes
# are timed over MAIN_ROUNDS traces.
TIMED_SUPERRES = ((8, 1, 960), (8, 0, 960), (8, 3, 960), (10, 1, 960),
                  (8, 1, 1280))
TIMED_GRAIN = ((8, 1, True), (8, 1, False), (8, 0, True), (8, 3, True),
               (10, 1, True), (12, 1, True))
MAIN_ROUNDS = 5

# integer ops of a super-res output (8 multiply-adds, the rounding and
# clip) and of a grained pixel (the LUT offsets, up to 4 LUT reads and
# 3 blends, the chroma luma average and combination, the scaling,
# rounding and clip): lower bounds from their arithmetic
SUPERRES_OPS_PER_PX = 20
GRAIN_OPS_PER_PX = 40


def _superres_work(jobs):
    """(bytes, ops) of a resize_frame call: each source's rows [:h] and
    columns [:src_w] read once, each destination written once, int32."""
    b = sum(4 * h * sw + 4 * d.numel() for _, sw, h, d, _, _, _ in jobs)
    ops = sum(SUPERRES_OPS_PER_PX * h * dw for _, _, h, _, dw, _, _ in jobs)
    return b, ops


def _grain_work(planes, fr, luts, scal, off):
    """(bytes, ops) of a film_grain call: each plane read and written
    once (the chroma's luma average reads the luma its block has read
    already), the LUTs and the offsets once, int32 pixels."""
    ch, cw = fr.chroma
    b = sum(8 * p.numel() for p in planes) + luts.numel() * 2 + \
        scal.numel() + off.numel() * 4
    px = sum((fr.h * fr.w if p == 0 else ch * cw)
             for p, on in enumerate(fr.apply) if on)
    return b, GRAIN_OPS_PER_PX * px


def phase_kernel_superres_grain(torch, card):
    """The super-res and film grain kernels against their plain versions
    (torch.equal) at 1080p: super-res to 1920 columns from 960 and 1280,
    every plane and the pre-CDEF snapshot in one launch; the grain of a
    1920x1080 frame with overlap on and off, then the flag combinations
    of kernel_cases GRAIN_VARIANTS (chroma scaling from luma, the
    restricted range with and without is_id, copied planes); bd 8/10/12,
    monochrome, 4:2:0, 4:2:2 and 4:4:4. Per case the launch's device us
    (median of 5), the plain version's ms and the bound. Returns per
    kernel its max abs error and the times of the main path's shapes
    (sr-1080p: 4:2:0 8-bit from 960 with the snapshot; fg-1080p: 4:2:0
    8-bit with overlap; their device us the median of MAIN_ROUNDS
    traces). Only the TIMED_* cases are timed: the rest are checked,
    and so are the small cases of tests/test_torch_cuda.py (kernel_cases
    superres_cases, superres_edge_cases, grain_cases, grain_edge_cases:
    odd sizes, 8192 columns, planes padded to 4 columns only, sources
    narrower than a staged span). Emits the persistent kernels' blocks a
    SM."""
    from dav1d_tpu_torch.ops import fg, superres
    from dav1d_tpu_torch.ops import kernel_cases as kc
    dev = torch.device("cuda")
    out = {k: {"max_abs_err": 0} for k in ("superres", "film_grain")}
    cases = []
    fill = _fill_us(torch)

    def record(kernel, what, fn, plain, work, main):
        us, per, timer = _launch_us(torch, fn, kernel + "_kernel", fill,
                                    MAIN_ROUNDS if main else 1)
        bound_ms, by = _bound(*work)
        row = {"case": what, "device_us": us, "device_us_rounds": per,
               "timer": timer, "plain_ms": _time_ms(torch, plain, iters=2),
               "bound_us": 1e3 * bound_ms, "bound_by": by}
        cases.append({"kernel": kernel, **row})
        if main:
            out[kernel].update(ms=us / 1e3, plain_ms=row["plain_ms"],
                               bound_ms=bound_ms, bound_by=by,
                               timer=timer)

    for bd in (8, 10, 12):
        for layout in (0, 1, 2, 3):
            for in_w in (960, 1280):
                case = kc.superres_case(bd, layout, in_w, 1920, 1080)
                jobs = kc.superres_args(case, dev)

                def plain(jobs=jobs, bd=bd):
                    return superres.resize_frame_plain(
                        [(s, sw, h, d.clone(), dw, st, m)
                         for s, sw, h, d, dw, st, m in jobs], bd)
                want = plain()
                got = superres.resize_frame_cuda(jobs, bd)
                torch.cuda.synchronize()
                what = f"superres bd={bd} layout={layout} {in_w}->1920"
                for i, (g, w) in enumerate(zip(got, want)):
                    out["superres"]["max_abs_err"] = max(
                        out["superres"]["max_abs_err"],
                        _check_equal(torch, g, w, f"{what} job {i}"))
                if (bd, layout, in_w) in TIMED_SUPERRES:
                    record("superres", what,
                           lambda jobs=jobs, bd=bd:
                           superres.resize_frame_cuda(jobs, bd), plain,
                           _superres_work(jobs),
                           (bd, layout, in_w) == TIMED_SUPERRES[0])
    grain = [(kc.grain_case(bd, layout, 1920, 1080, overlap=ov),
              f"bd={bd} layout={layout} overlap={ov}", (bd, layout, ov))
             for bd in (8, 10, 12) for layout in (0, 1, 2, 3)
             for ov in (True, False)]
    for name, v in kc.GRAIN_VARIANTS.items():
        v = dict(v)
        grain.append((kc.grain_case(v.pop("bd"), v.pop("layout"), 1920,
                                    1080, **v), name, None))
    for case, what, key in grain:
        args = kc.grain_args(case, dev)
        want = fg.film_grain_plain(*args)
        got = fg.film_grain_cuda(*args)
        torch.cuda.synchronize()
        what = f"film_grain 1920x1080 {what}"
        for i, (g, w) in enumerate(zip(got, want)):
            out["film_grain"]["max_abs_err"] = max(
                out["film_grain"]["max_abs_err"],
                _check_equal(torch, g, w, f"{what} plane {i}"))
        if key in TIMED_GRAIN:
            record("film_grain", what, lambda args=args:
                   fg.film_grain_cuda(*args),
                   lambda args=args: fg.film_grain_plain(*args),
                   _grain_work(*args), key == TIMED_GRAIN[0])
    # the small cases of tests/test_torch_cuda.py, checked only: odd
    # widths, 8192 columns, planes padded to 4 columns (last tiles and
    # units cut by the plane), sources narrower than a staged span
    small = {"superres": 0, "film_grain": 0}
    for case in kc.superres_cases() + kc.superres_edge_cases():
        jobs = kc.superres_args(case, dev)
        want = superres.resize_frame_plain(
            [(s, sw, h, d.clone(), dw, st, m)
             for s, sw, h, d, dw, st, m in jobs], case["bd"])
        got = superres.resize_frame_cuda(jobs, case["bd"])
        torch.cuda.synchronize()
        geo = [(j[1], j[4], tuple(j[3].shape)) for j in jobs]
        for i, (g, w) in enumerate(zip(got, want)):
            _check_equal(torch, g, w, f"superres bd={case['bd']} "
                         f"layout={case['layout']} {geo[i]} job {i}")
        small["superres"] += 1
    for case in kc.grain_cases() + kc.grain_edge_cases():
        args = kc.grain_args(case, dev)
        want = fg.film_grain_plain(*args)
        got = fg.film_grain_cuda(*args)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            _check_equal(torch, g, w, f"film_grain {case['params']} "
                         f"shapes {[tuple(p.shape) for p in args[0]]} "
                         f"plane {i}")
        small["film_grain"] += 1
    occupancy = {"superres": superres.occupancy(),
                 "film_grain_420": fg.occupancy(3, 1, 1),
                 "film_grain_444": fg.occupancy(3, 0, 0)}
    emit({"phase": "kernel_superres_grain", "card": card, "cases": cases,
          "small_cases_equal": small, "blocks_per_sm_and_sms": occupancy,
          "one_element_fill_us": fill,
          "max_abs_err": {k: v["max_abs_err"] for k, v in out.items()},
          "equal": True})
    return out


def _post_filter_kernel(name):
    """The kernel a POST_FILTERS / BIG_POST_FILTERS stream must launch."""
    return "film_grain" if name.startswith("fg-") or \
        name.endswith("-grain") else "superres"


def phase_post_filters(torch):
    """Decode the POST_FILTERS streams on cuda through the public API:
    picture and stream md5s, and each stream's super-res or film grain
    kernel launched."""
    for name, (pic_md5s, md5) in POST_FILTERS.items():
        _counts_reset()
        pics, digest, wall, _, md5s = _decode(f"{GOLDEN_DIR}/{name}.ivf",
                                              timed=False)
        launches = _counts()
        if md5s != pic_md5s or digest != md5:
            raise AssertionError(f"post_filters {name}: md5s {md5s} "
                                 f"{digest} != {pic_md5s} {md5}")
        k = _post_filter_kernel(name)
        if not launches[k]:
            raise AssertionError(f"post_filters {name}: the {k} kernel "
                                 f"never launched")
        emit({"phase": "post_filters", "stream": name, "md5": digest,
              "pictures": len(pics), "wall_ms": wall,
              "launches": {k: v for k, v in launches.items() if v}})


# integer ops of an intra-leftover output (a few tens: the smooth and
# directional blends, the filter-intra taps, CFL's scaling), a lower
# bound; the bytes are counted per family by _ipred_work
IPRED_OPS_PER_PX = 20
# the leftovers phase's streams: (name, path, per-picture md5s, stream
# md5, rounds of untimed walls)
LO_BENCH = (("s31", STREAM_1080P, MD5S_S31, MD5_S31, 2),
            ("s7", STREAM_S7, MD5S_S7, MD5_S7, 1),
            ("s21_realistic", STREAM_S21, MD5S_S21, MD5_S21, 1))
LO_STAGES = ("inter.lo_build", "inter.lo_device", "inter.fetch_region",
             "inter.leftovers", "inter.region_upload")


def _lo_env(mode):
    """DAV1D_TPU_LO set to `mode` inside the block, restored after."""
    from unittest import mock
    return mock.patch.dict(os.environ, {"DAV1D_TPU_LO": mode})


def _ipred_work(tables, shapes, ss_hor, ss_ver):
    """(bytes, ops) of a frame's leftover plan: tables the numpy frame
    tables (ops/ipred.py pack_plan), shapes each plane's (H, W). Bytes,
    all int32: every table entry (units, runs, levels, residual and
    block rows, WHT rows) read once; per unit the pixels of its plane
    that the entries its family's arithmetic uses name (a constant reads
    no memory), a CFL unit's luma rect, its outputs inside the plane
    written once (a residual lands on them: no further pixel traffic);
    per residual job its coefficients. The entries used (top C + 1 ..,
    left C - 1 .., corner C): DC w + h, TOP_DC and V w, LEFT_DC and H h,
    DC_128 none (CFL the same by its DC mode); Paeth, filter-intra and
    Z2 w + h and the corner; smooth w + h (its right and bottom are the
    edges' last), smooth V w and the bottom, smooth H h and the right;
    Z1 w + min(w, h) of the top (Z3 h + min(w, h) of the left), and the
    corner when filtered or upsampled. For Z1, Z2 and Z3 that is the
    span their edge filter and upsampling read; a steep angle's
    interpolation alone reaches fewer. Ops: IPRED_OPS_PER_PX an output
    and the residuals' transform ops (_itx_work)."""
    import numpy as np
    from dav1d_tpu_torch.ops import ipred
    from dav1d_tpu_torch.ops import ipred_ref as r
    from dav1d_tpu_torch.ops.itx import CF_LEN
    u = tables["units"].astype(np.int64)
    fam, w, h, mode = u[:, 1], u[:, 2], u[:, 3], u[:, 8]
    s = fam == ipred.FAM_S
    z1, z3 = fam == ipred.FAM_Z1, fam == ipred.FAM_Z3
    dc = np.where(s, mode, np.where(fam == ipred.FAM_CFL, u[:, 13], -1))
    both = np.isin(dc, (r.DC_PRED, r.PAETH_PRED, r.SMOOTH_PRED)) | \
        (fam == ipred.FAM_F) | (fam == ipred.FAM_Z2)
    top = np.where(z1, w + np.minimum(w, h), np.where(
        both | np.isin(dc, (r.TOP_DC_PRED, r.VERT_PRED, r.SMOOTH_V_PRED)),
        w, 0))
    left = np.where(z3, h + np.minimum(w, h), np.where(
        both | np.isin(dc, (r.LEFT_DC_PRED, r.HOR_PRED, r.SMOOTH_H_PRED)),
        h, 0))
    corner = (s & (mode == r.PAETH_PRED)) | (fam == ipred.FAM_F) | \
        (fam == ipred.FAM_Z2) | ((z1 | z3) & ((u[:, 9] > 0) | (u[:, 10] > 0)))
    k = np.arange(ipred.EDGE_LEN)[None] - ipred.C
    read = ((k > 0) & (k <= top[:, None])) | \
        ((k < 0) & (-k <= left[:, None])) | \
        ((k == 0) & corner[:, None]) | \
        ((k == w[:, None]) & (s & (mode == r.SMOOTH_H_PRED))[:, None]) | \
        ((k == -h[:, None]) & (s & (mode == r.SMOOTH_V_PRED))[:, None])
    H, W = (np.array([sh[i] for sh in shapes], np.int64)[u[:, 0]]
            for i in (0, 1))
    q = ipred.run_indices(tables["runs"][u[:, 7]], H * W)
    pixel = read & (q < (H * W)[:, None])
    luma = np.where(fam == ipred.FAM_CFL,
                    (u[:, 10] << ss_ver) * (u[:, 11] << ss_hor), 0)
    out = np.clip(W - u[:, 5], 0, w) * np.clip(H - u[:, 4], 0, h)
    res, wht = tables["res"], tables["wht"]
    coefs = int(CF_LEN[res[:, 0]].sum()) + 16 * len(wht)
    ops = IPRED_OPS_PER_PX * int((w * h).sum())
    for jobs, is_wht in ((res, False), (wht[:, :6], True)):
        if len(jobs):
            ops += _itx_work(jobs, is_wht)[1]
    return (int(4 * (sum(t.size for t in tables.values()) + pixel.sum() +
                     luma.sum() + out.sum() + coefs)), int(ops))


def _ipred_plans(path):
    """The first inter frame of `path` (2 temporal units) decoded on
    cuda with its leftovers forced onto the device: per ipred_plan call,
    (the planes before it (device copies), its tables and pool (the
    frame upload's device views), bd, ss_hor, ss_ver)."""
    from dav1d_tpu_torch.ops import ipred
    plans = []
    orig = ipred.ipred_plan

    def spy(planes, tables, pool, *args):
        plans.append(([p.clone() for p in planes], dict(tables), pool) +
                     args)
        return orig(planes, tables, pool, *args)
    ipred.ipred_plan = spy
    try:
        with _lo_env("device"):
            _decode(path, timed=False, n_tu=2)
    finally:
        ipred.ipred_plan = orig
    return plans


def _ptxas_summary(lines):
    """{kernel instantiation: "N registers, ..."} from nvcc's -Xptxas -v
    lines of one library (None when it was not built in this run)."""
    if not lines:
        return None
    out, name = {}, None
    for ln in lines:
        if "entry function" in ln:
            name = ln.split("'")[1]
        elif "registers" in ln and name:
            out[name] = ln.split(":", 1)[1].strip()
    return out


def phase_kernel_ipred(torch, card, ptxas=None):
    """The intra-leftover frame kernel against plan_plain (torch.equal):
    every ops/kernel_cases.py ipred_case as a one-level plan (bd 8/10/12;
    4:2:0, 4:2:2, 4:4:4 and monochrome; every family at every geometry
    it takes, 4..64, over every plane; units cut by the plane's right
    and bottom edges; edges from the availability walk, the constant
    fills and tlf) and every plan_case (three levels with residuals and
    WHT jobs between them, bd 8/10/12), each in one launch; then the
    whole plan of the first inter frame of s31 and of s7 with the
    leftovers forced onto the device, kernel and plain on the card on
    the captured planes, with its device us (_launch_us, the whole
    frame's launch: s31's over MAIN_ROUNDS traces), the plain version's
    ms, the bound, the grid, blocks a SM, dynamic shared bytes and the
    ptxas registers (`ptxas`: phase_build's lines for ipred). Returns
    the kernels-line numbers (s31's frame)."""
    from dav1d_tpu_torch.ops import ipred
    from dav1d_tpu_torch.ops import kernel_cases as kc
    dev = torch.device("cuda")
    err = n_units = 0
    cases = kc.ipred_cases() + kc.plan_cases()
    for case in cases:
        args = (case["bd"], case["ss_hor"], case["ss_ver"])
        got, tables, pool = kc.plan_args(case, dev)
        want = [p.clone() for p in got]
        before = ipred.LAUNCHES["ipred"]
        ipred.plan_cuda(got, tables, pool, *args)
        if ipred.LAUNCHES["ipred"] != before + 1:
            raise AssertionError("kernel_ipred: not one launch a plan")
        ipred.plan_plain(want, tables, pool, *args)
        torch.cuda.synchronize()
        for pi, (a, b) in enumerate(zip(got, want)):
            err = max(err, _check_equal(torch, a, b, f"ipred bd={args[0]} "
                                        f"ss={args[1:]} plane {pi} "
                                        f"levels {len(tables['levels'])}"))
        n_units += len(tables["units"])
    occ = {bd: ipred.occupancy(bd) for bd in (8, 12)}
    emit({"phase": "kernel_ipred", "card": card, "cases": len(cases),
          "units": n_units, "max_abs_err": err, "equal": True,
          "ptxas": _ptxas_summary(ptxas),
          "blocks_per_sm": {bd: o[0] for bd, o in occ.items()},
          "sms": occ[8][1],
          "dynamic_shared_bytes": {bd: o[2] for bd, o in occ.items()}})
    out = {}
    fill = _fill_us(torch)
    for name, path in (("s31", STREAM_1080P), ("s7", STREAM_S7)):
        plans = _ipred_plans(path)
        if len(plans) != 1:
            raise AssertionError(f"kernel_ipred {name}: {len(plans)} plans "
                                 f"on the first inter frame")
        planes, tables, pool, *args = plans[0]
        got = [p.clone() for p in planes]
        want = [p.clone() for p in planes]
        ipred.plan_cuda(got, tables, pool, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ipred.plan_plain(want, tables, pool, *args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for pi, (a, b) in enumerate(zip(got, want)):
            err = max(err, _check_equal(torch, a, b, f"ipred {name} "
                                        f"frame 1 plane {pi}"))
        host = {k: v.cpu().numpy() for k, v in tables.items()}
        work = _ipred_work(host, [tuple(p.shape) for p in planes],
                           *args[1:])
        # replayed on the captured planes: each level rewrites what it
        # predicts before its residuals add, and reads only pixels the
        # plan never writes or that a lower level rewrote first, so
        # every replay gives the same planes
        us, per_round, timer = _launch_us(
            torch, lambda a=(planes, tables, pool, *args):
            ipred.plan_cuda(*a), "ipred_frame_kernel", fill,
            MAIN_ROUNDS if name == "s31" else 1, n=8)
        bound = _bound(*work)
        lv = host["levels"].astype("int64")
        per, sms, smem = ipred.occupancy(args[0])
        emit({"phase": "kernel_ipred", "card": card, "stream": name,
              "frame": 1, "launches": 1, "levels": len(lv),
              "units": len(host["units"]),
              "large_units": int((lv[:, 1] - lv[:, 0]).sum()),
              "largest_level_units": int((lv[:, 2] - lv[:, 0]).max()),
              "residual_jobs": len(host["res"]),
              "residual_blocks": len(host["blocks"]),
              "wht_jobs": len(host["wht"]),
              "grid_barriers": int(len(lv) - 1 + ((lv[:, 4] > lv[:, 3]) |
                                                 (lv[:, 6] > lv[:, 5])).sum()),
              "table_bytes": int(sum(v.nbytes for v in host.values())),
              "frame_us": us, "frame_us_per_round": per_round,
              "timer": timer, "one_element_fill_us": fill,
              "grid": per * sms, "blocks_per_sm": per,
              "dynamic_shared_bytes": smem, "plain_ms": plain_ms,
              "bytes": work[0], "ops": work[1], "bound_ms": bound[0],
              "bound_by": bound[1], "max_abs_err": err, "equal": True})
        out[name] = {"ms": us / 1e3, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "max_abs_err": err}
    return out["s31"]


def _lo_decode(torch, path):
    """One timed decode of `path` on cuda (stage syncs on): per inter
    frame with leftovers, its leftover count, whether the device served
    it (levels, units), the ms of each LO_STAGES stage and the bytes
    that cross for the leftovers: on the device route the plan's tables
    in the frame's one upload (lo_table_bytes; upload_bytes the whole
    upload, tables and coefficient pool), on the host route the rows
    fetched and uploaded again (region_bytes, each way); the picture
    md5s, the stream md5 and the ipred launches."""
    from dav1d_tpu_torch.ops import mc_fused
    from dav1d_tpu_torch.recon import inter_device
    from dav1d_tpu_torch.utils import timing
    frames, uploads = [], []
    orig = inter_device.DeviceInterReconstructor.run_native
    orig_upload = mc_fused._upload

    def upload(tables, pool, device):
        uploads.append(sum(t.nbytes for t in tables.values()) + pool.nbytes)
        return orig_upload(tables, pool, device)

    def spy(self, jobs):
        before = {k: timing._T.get(k, 0.0) for k in LO_STAGES}
        uploads.clear()
        out = orig(self, jobs)
        if len(self.leftovers):
            plan = self._dev_lo
            spans = self._region_spans if plan is None else ()
            frames.append({
                "n_leftovers": len(self.leftovers),
                "levels": len(plan.levels) if plan else None,
                "units": plan.n_units if plan else None,
                **{k.split(".")[1]: (timing._T.get(k, 0.0) - before[k]) * 1e3
                   for k in LO_STAGES},
                "lo_table_bytes": sum(v.nbytes for v in
                                      self.lo_tables.values())
                if plan else 0,
                "upload_bytes": sum(uploads),
                "region_bytes": sum((b - a) * hp.shape[1] * hp.itemsize
                                    for hp, (a, b) in
                                    zip(self.pic.planes, spans or ()))})
        return out
    inter_device.DeviceInterReconstructor.run_native = spy
    mc_fused._upload = upload
    _counts_reset()
    try:
        pics, digest, wall, stages, md5s = _decode(path, timed=True)
    finally:
        inter_device.DeviceInterReconstructor.run_native = orig
        mc_fused._upload = orig_upload
    return frames, md5s, digest, wall, _counts()["ipred"]


def phase_leftovers(torch, card):
    """s31, s7 and s21_realistic decoded whole on cuda with the
    leftovers forced onto the device and then onto the host
    (DAV1D_TPU_LO=device, =host): the same pictures, each stream on its
    recorded md5s (per picture and over the stream); on the device
    route the ipred kernel launched, no fallback and no row fetched
    back on any frame; per frame both routes' stage ms
    beside the leftover, level and unit counts (one decode with stage
    syncs each), and untimed walls of the routes in turns. Then the
    LO_STREAMS (GOLDEN_DIR) under =device to their golden md5s. Returns
    the ipred launches of s31's device-route decode (counts set to 0
    just before it, read just after)."""
    from dav1d_tpu_torch.recon import ipred_device
    launches = 0
    for name, path, pic_md5s, md5, rounds in LO_BENCH:
        runs = {}
        for mode in ("device", "host"):
            with _lo_env(mode):
                stats = dict(ipred_device.STATS)
                frames, md5s, digest, wall, launched = _lo_decode(torch,
                                                                  path)
                stats = {k: ipred_device.STATS[k] - stats[k]
                         for k in stats}
            if digest != md5 or md5s != pic_md5s:
                raise AssertionError(f"leftovers {name} {mode}: md5 "
                                     f"{digest} {md5s}")
            runs[mode] = {"frames": frames, "md5s": md5s, "stats": stats,
                          "ipred_launches": launched, "synced_wall_ms": wall,
                          "wall_ms": []}
        # untimed walls, the routes in turns (device, host, host, device)
        for mode in ("device", "host", "host", "device") * rounds:
            with _lo_env(mode):
                _, d2, untimed, _, _ = _decode(path, timed=False)
            if d2 != digest:
                raise AssertionError(f"leftovers {name} {mode}: md5 {d2} "
                                     f"on an untimed decode")
            runs[mode]["wall_ms"].append(untimed)
        dv = runs["device"]
        if dv["md5s"] != runs["host"]["md5s"]:
            raise AssertionError(f"leftovers {name}: device != host")
        if not dv["ipred_launches"] or dv["stats"]["fallbacks"] or \
                any(f["levels"] is None or f["fetch_region"] or
                    f["region_upload"] for f in dv["frames"]):
            raise AssertionError(f"leftovers {name}: device route not "
                                 f"taken on every frame: {dv}")
        emit({"phase": "leftovers", "card": card, "stream": name,
              "md5": digest, **runs})
        launches = launches or dv["ipred_launches"]   # s31's, first
    for name, (pic_md5s, md5) in LO_STREAMS.items():
        with _lo_env("device"):
            _counts_reset()
            _, digest, _, _, md5s = _decode(f"{GOLDEN_DIR}/{name}.ivf",
                                            timed=False)
        if md5s != pic_md5s or digest != md5 or not _counts()["ipred"]:
            raise AssertionError(f"leftovers {name}: {md5s} {digest}")
    emit({"phase": "leftovers", "card": card, "lo_streams": len(LO_STREAMS),
          "equal": True})
    return launches


# the collector phase's routes for s31's first COLLECTOR_TU temporal
# units: (name, environment); the emitter route (the default) is the
# one the collector walk is held against
COLLECTOR_TU = 3
COLLECTOR_ROUTES = (("emitter", {}),
                    ("collector", {"DAV1D_TPU_INTERJOBS": "python"}))
# the kernels both routes run on s31's inter frames
COLLECTOR_KERNELS = ("mc_put", "mc_comp", "itx_add", "mc_warp", "mc_obmc")


def _env(env):
    """os.environ updated with `env` inside the block, restored after."""
    from unittest import mock
    return mock.patch.dict(os.environ, env)


def _route_decode(path, timed, n_tu=None):
    """One decode of `path` on cuda (stage syncs on when timed): the
    decode's (pictures, md5, wall ms, stage ms, picture md5s) and per
    inter frame its route (emitter, collector walk) and its inter.*
    stage ms."""
    from dav1d_tpu_torch.recon import inter_device
    from dav1d_tpu_torch.utils import timing
    cls = inter_device.DeviceInterReconstructor
    orig = (inter_device.reconstruct_inter_frame_device, cls.run)
    frames = []

    def frame(plan, refp, device, pool=None):
        before = dict(timing._T)
        frames.append({"route": "emitter"})
        pic = orig[0](plan, refp, device, pool)
        frames[-1]["stage_ms"] = {
            k: (v - before.get(k, 0.0)) * 1e3 for k, v in timing._T.items()
            if k.startswith("inter.") and v != before.get(k, 0.0)}
        return pic

    def walk(self):
        frames[-1]["route"] = "collector"
        return orig[1](self)
    inter_device.reconstruct_inter_frame_device = frame
    cls.run = walk
    try:
        out = _decode(path, timed=timed, n_tu=n_tu)
    finally:
        inter_device.reconstruct_inter_frame_device = orig[0]
        cls.run = orig[1]
    return out, frames


def phase_collector(torch, card):
    """The route of inter frames the native emitter does not serve
    (ROADMAP item 9b): s31's first
    COLLECTOR_TU temporal units (1920x1080, a keyframe and inter frames
    with warp and OBMC) decoded on cuda on each of COLLECTOR_ROUTES,
    each picture on MD5S_S31, every inter frame on its route, the
    collector walk launching the kernels of the emitter route; per inter frame each route's inter.* stage ms and
    over the decode every stage's ms (one decode with stage syncs,
    after a warm one), and an untimed wall.
    Then the GOLDEN_WALKS and LO_STREAMS streams (GOLDEN_DIR) under
    DAV1D_TPU_INTERJOBS=python to their golden md5s, their inter frames
    on the collector walk. The environment is restored after each
    run."""
    want = MD5S_S31[:COLLECTOR_TU]
    n_inter = COLLECTOR_TU - 1
    for name, env in COLLECTOR_ROUTES:
        with _env(env):
            _route_decode(STREAM_1080P, False, COLLECTOR_TU)      # warm
            _counts_reset()
            (pics, _, wall, stages, md5s), frames = _route_decode(
                STREAM_1080P, True, COLLECTOR_TU)
            launches = _counts()
            (_, _, untimed, _, md5s2), _ = _route_decode(
                STREAM_1080P, False, COLLECTOR_TU)
        if md5s != want or md5s2 != want:
            raise AssertionError(f"collector {name}: md5s {md5s} {md5s2} "
                                 f"!= {want}")
        if len(frames) != n_inter or \
                any(f["route"] != name for f in frames):
            raise AssertionError(f"collector {name}: frames took "
                                 f"{[f['route'] for f in frames]}")
        for k in COLLECTOR_KERNELS:
            if not launches[k]:
                raise AssertionError(f"collector {name}: the {k} kernel "
                                     f"never launched")
        emit({"phase": "collector", "card": card, "route": name,
              "env": env, "stream": STREAM_1080P, "pictures": len(pics),
              "md5s": md5s, "frames": frames, "synced_wall_ms": wall,
              "stage_ms": stages, "wall_ms": untimed,
              "launches": {k: v for k, v in launches.items() if v}})
    streams = {**GOLDEN_WALKS, **LO_STREAMS}
    with _env({"DAV1D_TPU_INTERJOBS": "python"}):
        for name, (pic_md5s, md5) in streams.items():
            (_, digest, _, _, md5s), frames = _route_decode(
                f"{GOLDEN_DIR}/{name}.ivf", False)
            if md5s != pic_md5s or digest != md5:
                raise AssertionError(f"collector {name}: md5s {md5s} "
                                     f"{digest} != {pic_md5s} {md5}")
            if any(f["route"] != "collector" for f in frames):
                raise AssertionError(f"collector {name}: a frame took the "
                                     f"emitter route")
    emit({"phase": "collector", "card": card, "streams": len(streams),
          "equal": True})


SHARDED_TU = 3                  # s31's first pictures on the meshes
SHARDED_COUNTS = (2, 4)         # s31's meshes (None: no mesh, the base)
MESH_COUNTS = (1, 2, 4, 8)      # the mesh streams' meshes
SHARDED_PROFILE = 4             # the mesh of the per-launch device times
# the kernel of each wrapper the sharded path calls, and the bytes of a
# call's ext planes: each input plane read once, each output written
# once (int32), the deblock's and CDEF's maps
_EXT_BYTES = {
    ("lf", "deblock_frame", "deblock"):
        lambda e, *_: sum(8 * p.numel() + 4 * v[0].numel()
                          for p, _l, v, _h in e),
    ("cdef", "cdef_planes", "cdef"):
        lambda planes, maps, *_: sum(8 * p.numel() for p in planes) +
        4 * maps.numel(),
    ("lr", "wiener_frame", "lr_wiener"):
        lambda planes, *_: sum(12 * p[0].numel() for p in planes),
    ("lr", "sgr_frame", "lr_sgr"):
        lambda planes, *_: sum(12 * p[0].numel() for p in planes),
    ("mc", "put_planes", "mc_put"):
        lambda planes, *_: sum(4 * p[1].numel() for p in planes),
    ("mc_warp", "warp_planes", "mc_warp"):
        lambda planes, *_: sum(4 * p[1].numel() for p in planes),
    ("mc", "comp", "mc_comp"): lambda refs, jobs, plane, *_:
        8 * plane.numel(),
    ("mc_obmc", "obmc_planes", "mc_obmc"):
        lambda planes, *_: sum(8 * p[1].numel() for p in planes),
    ("itx", "itx_add", "itx_add"): lambda pool, jobs, plane, *_:
        8 * plane.numel(),
    ("superres", "resize_frame", "superres"):
        lambda jobs, *_: sum(4 * (j[0].numel() + j[3].numel())
                             for j in jobs),
}


def _mesh_of(n):
    """A ("gop", "tile") mesh of n shards round-robin over the cards
    present (every shard on cuda:0 with one card)."""
    import numpy as np
    from dav1d_tpu_torch.parallel.sharded import Mesh, round_robin
    devs = np.array(round_robin(n, "cuda"), dtype=object)
    gop = 2 if n % 2 == 0 else 1
    return Mesh(devs.reshape(gop, n // gop), ("gop", "tile"))


class _ExtBytes:
    """Inside the block, the wrappers of _EXT_BYTES count their calls and
    their ext planes' bytes per kernel (self.calls, self.bytes)."""

    def __enter__(self):
        from dav1d_tpu_torch.ops import cdef, itx, lf, lr, mc, mc_obmc, \
            mc_warp, superres
        mods = {"lf": lf, "cdef": cdef, "lr": lr, "mc": mc, "itx": itx,
                "mc_warp": mc_warp, "mc_obmc": mc_obmc,
                "superres": superres}
        self.calls, self.bytes, self.saved = {}, {}, []
        for (m, fn, k), count in _EXT_BYTES.items():
            orig = getattr(mods[m], fn)
            self.saved.append((mods[m], fn, orig))

            def wrap(*a, _o=orig, _k=k, _c=count, **kw):
                self.calls[_k] = self.calls.get(_k, 0) + 1
                self.bytes[_k] = self.bytes.get(_k, 0) + _c(*a)
                return _o(*a, **kw)
            setattr(mods[m], fn, wrap)
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in self.saved:
            setattr(mod, fn, orig)


def _sharded_frame1(torch, mesh):
    """s31's frame 1 decoded on `mesh` after its keyframe
    (n_threads=1), under the profiler: per kernel its launches, the
    median device us of a launch, and the ext bytes of its calls."""
    import statistics
    from torch.profiler import ProfilerActivity, profile
    from dav1d_tpu_torch.api import Decoder, Settings
    from dav1d_tpu_torch.bitstream.ivf import IvfReader
    tus = list(IvfReader(open(os.path.join(ROOT, STREAM_1080P),
                              "rb").read()))[:2]
    dec = Decoder(Settings(n_threads=1, sharding_mesh=mesh))
    dec.send_data(tus[0].data)
    list(dec.pictures())
    torch.cuda.synchronize()
    with _ExtBytes() as eb, profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        dec.send_data(tus[1].data)
        list(dec.pictures())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dec.close()
    us, busy = {}, 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy += e.time_range.elapsed_us()
        for k, keys in KERNEL_NAMES.items():
            if any(n in e.name for n in keys):
                us.setdefault(k, []).append(e.time_range.elapsed_us())
    out = {}
    for k, n in eb.calls.items():
        per = eb.bytes[k] / n
        out[k] = {"calls": n, "launches": len(us.get(k, [])),
                  "us": statistics.median(us[k]) if k in us else None,
                  "ext_bytes_per_call": per,
                  "bound_us": per / HBM_BYTES_PER_S * 1e6}
    return {"kernels": out, "device_busy_ms": busy / 1e3,
            "profiled_wall_ms": wall,
            "idle_share": 1 - busy / 1e3 / wall if wall else None}


def _window_checks(torch, mesh):
    """s31's frame 1 decoded on `mesh` with the sharded deblock's, CDEF's
    and LR's inputs and outputs kept; each stage's single-device kernel
    (ops/lf.py deblock_planes_device, ops/cdef.py cdef_planes_device,
    ops/lr.py lr_planes_device) run on the gathered inputs, and every
    shard's output torch.equal to it over its owned columns (shard 0,
    the interior shards, the last). Returns {stage: shards checked}."""
    from dav1d_tpu_torch.ops import cdef, lf, lr
    from dav1d_tpu_torch.parallel.sharded import tile_devices
    from dav1d_tpu_torch.recon import sharded_stageb as sb
    names = ("deblock_planes_sharded", "cdef_planes_sharded",
             "lr_planes_sharded")
    orig = {k: getattr(sb, k) for k in names}
    rec = {}

    def spy(name):
        def fn(*a):
            out = orig[name](*a)
            rec[name] = (a, out)        # the last frame's: frame 1
            return out
        return fn
    for k in names:
        setattr(sb, k, spy(k))
    try:
        _decode(STREAM_1080P, timed=False, n_tu=2, n_threads=1, mesh=mesh)
    finally:
        for k in names:
            setattr(sb, k, orig[k])
    dev = tile_devices(mesh)[0]         # the decode's device
    out = {}
    for name, single in (("deblock_planes_sharded",
                          lambda fl, a: lf.deblock_planes_device(fl, a[1],
                                                                 a[2])),
                         ("cdef_planes_sharded",
                          lambda fl, a: cdef.cdef_planes_device(fl, a[1],
                                                                a[2])),
                         ("lr_planes_sharded",
                          lambda fl, a: lr.lr_planes_device(
                              fl, [sb.gather(p, f.shape[1], dev)
                                   for p, f in zip(a[1], fl)], a[2],
                              a[3]))):
        if name not in rec:             # the stage is off on this frame
            continue
        a, got = rec[name]
        plan = a[2] if name == "lr_planes_sharded" else a[1]
        f = plan.f
        aw = (f.frame_hdr.width[1] + 127) & ~127
        widths = [aw] + [(aw + f.ss_hor) >> f.ss_hor] * (len(a[0]) - 1)
        full = [sb.gather(p, w, dev) for p, w in zip(a[0], widths)]
        want = single(full, a)
        torch.cuda.synchronize()
        for pi, (g, w) in enumerate(zip(got, want)):
            sw = g[0].shape[1]
            for s, t in enumerate(g):
                c0, c1 = s * sw, min((s + 1) * sw, w.shape[1])
                if c1 > c0 and not torch.equal(t[:, :c1 - c0].to(dev),
                                               w[:, c0:c1]):
                    raise AssertionError(f"sharded {name} plane {pi} "
                                         f"shard {s} != one device's")
        out[name.split("_")[0]] = list(range(len(got[0])))
    return out, rec["deblock_planes_sharded"][0][1]


def phase_sharded(torch, card):
    """The sharded decode (ROADMAP item 10) on the card: meshes of
    logical shards, round-robin over the cards present (all on cuda:0
    with one card), so on one card the cost of sharding, not a scaling
    result. s31's first SHARDED_TU pictures (full 1920x1080 width)
    without a mesh and on SHARDED_COUNTS shards, each picture on
    MD5S_S31, every MAIN_KERNELS kernel launched under the mesh and no
    ipred launch (the leftovers replay on the host), untimed walls in
    turns (INTER_REPEATS each, the first round warming), per-stage ms of
    a synchronized decode; the mesh
    streams (MESH_MD5S) at MESH_COUNTS shards on their recorded md5s,
    super-res launched on its stream; on s31 frame 1 at SHARDED_PROFILE
    shards each sharded filter stage held to its single-device kernel
    over every shard's owned columns, itx_sharded_check (with its work
    and bound, _itx_check_work), and per kernel
    its launches, device us of a launch, and the bound over its ext
    planes' bytes, with the device's busy ms and idle share, beside the
    same frame without a mesh."""
    import statistics
    from dav1d_tpu_torch.parallel.sharded import itx_sharded_check
    want = MD5S_S31[:SHARDED_TU]
    counts = (None,) + SHARDED_COUNTS
    meshes = {n: None if n is None else _mesh_of(n) for n in counts}
    walls = {n: [] for n in counts}
    for r in range(INTER_REPEATS):          # untimed walls, in turns
        for n in counts if r % 2 == 0 else counts[::-1]:
            _, _, untimed, _, md5s = _decode(STREAM_1080P, False,
                                             n_tu=SHARDED_TU, mesh=meshes[n])
            if md5s != want:
                raise AssertionError(f"sharded {n}: md5s {md5s} != {want}")
            walls[n].append(untimed)
    for n in counts:
        mesh = meshes[n]
        _counts_reset()
        _, _, wall, stages, md5s = _decode(STREAM_1080P, True,
                                           n_tu=SHARDED_TU, mesh=mesh)
        launches = _counts()
        if md5s != want:
            raise AssertionError(f"sharded {n}: md5s {md5s} != {want}")
        for k in MAIN_KERNELS:
            if not launches[k]:
                raise AssertionError(f"sharded {n}: the {k} kernel never "
                                     "launched")
        if launches["ipred"]:
            raise AssertionError(f"sharded {n}: ipred launched")
        emit({"phase": "sharded", "card": card, "stream": STREAM_1080P,
              "shards": n, "mesh": None if mesh is None else
              [str(d) for d in mesh.devices.reshape(-1)],
              "label": "one card: the cost of sharding, not scaling",
              "pictures": len(md5s), "md5s": md5s,
              "synced_wall_ms": wall,
              "wall_ms": statistics.median(walls[n]),
              "walls_ms": walls[n],
              "stage_ms": {k: v for k, v in stages.items()
                           if k.startswith(("inter.", "filters.",
                                            "deblock.", "stage_a",
                                            "intra."))},
              "launches": {k: v for k, v in launches.items() if v}})
    streams = {}
    for name, md5 in MESH_MD5S.items():
        path = f"{GOLDEN_DIR}/{name}.ivf"
        for n in MESH_COUNTS:
            _counts_reset()
            _, digest, wall, _, _ = _decode(path, False, n_threads=1,
                                            mesh=_mesh_of(n))
            launches = _counts()
            if digest != md5:
                raise AssertionError(f"sharded {name} at {n}: {digest} != "
                                     f"{md5}")
            if "superres" in name and not launches["superres"]:
                raise AssertionError(f"sharded {name}: super-res never "
                                     "launched")
            streams[f"{name}@{n}"] = {
                "wall_ms": wall,
                "launches": {k: v for k, v in launches.items() if v}}
    mesh = _mesh_of(SHARDED_PROFILE)
    checked, plan1 = _window_checks(torch, mesh)
    energy = itx_sharded_check(plan1, 8, mesh)
    if not energy > 0:
        raise AssertionError("itx_sharded_check: no residual energy")
    emit({"phase": "sharded", "card": card, "mesh_streams": streams,
          "window_checks": checked, "itx_sharded_check_energy": energy,
          "itx_sharded_check_work": _itx_check_work(plan1),
          "frame1": _sharded_frame1(torch, mesh),
          "frame1_no_mesh": _sharded_frame1(torch, None),
          "frame1_shards": SHARDED_PROFILE})


# the golden_route phase: the stream of each family decoded again on the
# device route (name, a mesh of that many shards or None), and the mesh
# stream the route decodes with a mesh in its Settings
GOLDEN_ROUTE_CHECKS = (("interintra", None), ("fg-inter", None),
                       ("lo-base", None), ("mesh-rich-256x128", 2))


def phase_golden_route(torch, card):
    """The golden host route (DAV1D_TPU_BACKEND=numpy, ROADMAP item 16)
    with a default Settings(): the GOLDEN_WALKS, POST_FILTERS and
    LO_STREAMS streams and a mesh stream with a 2-shard mesh in the
    Settings, each on its recorded md5s (per picture, and over the
    stream; the mesh stream's over the stream), with no kernel launched
    (every LAUNCHES count unchanged) and no device memory allocated
    (torch.cuda.memory_allocated unchanged) over the decodes; then one
    stream of each family on the device route to the same pictures. The
    route's seconds and each stream's wall ms."""
    import gc
    from unittest import mock
    t0 = time.perf_counter()
    counts = _counts()
    torch.cuda.synchronize()
    gc.collect()                # earlier phases' tensors freed first
    mem = torch.cuda.memory_allocated()
    golden, walls = {}, {}
    mesh_name, shards = GOLDEN_ROUTE_CHECKS[-1]
    with mock.patch.dict(os.environ, {"DAV1D_TPU_BACKEND": "numpy"}):
        for name, (pic_md5s, md5) in {**GOLDEN_WALKS, **POST_FILTERS,
                                      **LO_STREAMS}.items():
            _, digest, walls[name], _, md5s = _decode(
                f"{GOLDEN_DIR}/{name}.ivf", timed=False)
            if md5s != pic_md5s or digest != md5:
                raise AssertionError(f"golden_route {name}: md5s {md5s} "
                                     f"{digest} != {pic_md5s} {md5}")
            golden[name] = md5s
        _, digest, walls[mesh_name], _, golden[mesh_name] = _decode(
            f"{GOLDEN_DIR}/{mesh_name}.ivf", timed=False,
            mesh=_mesh_of(shards))
        if digest != MESH_MD5S[mesh_name]:
            raise AssertionError(f"golden_route {mesh_name}: md5 {digest}")
    torch.cuda.synchronize()
    gc.collect()
    if _counts() != counts:
        raise AssertionError(f"golden_route: kernels launched: "
                             f"{counts} -> {_counts()}")
    if torch.cuda.memory_allocated() != mem:
        raise AssertionError(f"golden_route: device memory {mem} -> "
                             f"{torch.cuda.memory_allocated()}")
    seconds = time.perf_counter() - t0
    for name, n in GOLDEN_ROUTE_CHECKS:
        _, _, _, _, md5s = _decode(f"{GOLDEN_DIR}/{name}.ivf", timed=False,
                                   mesh=n and _mesh_of(n))
        if md5s != golden[name]:
            raise AssertionError(f"golden_route {name}: the device route's "
                                 f"{md5s} != the golden route's "
                                 f"{golden[name]}")
    emit({"phase": "golden_route", "card": card, "streams": len(golden),
          "seconds": seconds, "wall_ms": walls,
          "device_route_equal": [n for n, _ in GOLDEN_ROUTE_CHECKS]})


def mc_batch_check(torch, device):
    """Every case of kernel_cases.mc_batch_cases at bd 8/10/12 through
    its ops/mc.py program on `device` and on the CPU: torch.equal.
    Returns {program: cases}."""
    from dav1d_tpu_torch.ops import kernel_cases as kc
    from dav1d_tpu_torch.ops import mc
    done = {}
    for bd in (8, 10, 12):
        for name, args, extra in kc.mc_batch_cases(bd):
            fn = getattr(mc, name)
            want = fn(*(torch.from_numpy(a) for a in args), *extra)
            got = fn(*(_t(torch, a, device) for a in args), *extra)
            pairs = zip(got, want) if isinstance(got, tuple) else \
                [(got, want)]
            for g, w in pairs:
                if g.device.type != torch.device(device).type:
                    raise AssertionError(f"mc_batch {name}: ran on "
                                         f"{g.device}")
                _check_equal(torch, g.cpu(), w, f"mc_batch {name} bd {bd}")
            done[name] = done.get(name, 0) + 1
    return done


def phase_mc_batch(torch, card):
    """dav1d_tpu's batched per-block MC programs (ROADMAP queue 2 entry
    15) in their plain torch versions, which have no kernel of their
    own: mc_batch_check on cuda."""
    t0 = time.perf_counter()
    done = mc_batch_check(torch, "cuda")
    emit({"phase": "mc_batch", "card": card, "cases": done, "equal": True,
          "seconds": time.perf_counter() - t0})


PIPELINE_DEPTHS = (1, 2, 3, 4)  # the Stage-B depths of s31's sweep
PIPELINE_ROUNDS = 3             # walls a depth, the depths in turns


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def phase_pipeline(torch, card):
    """The Stage-B frame pipeline's depth (ROADMAP item 7): s31's 8
    frames through Decoder(Settings(max_frame_delay=d)) with
    DAV1D_TPU_STAGEB_DEPTH=d for each d of PIPELINE_DEPTHS, in bench.py's
    loop (every unit sent, then the pictures drained: _decode's
    feed_ahead), and at the default depth in the CLI's loop (each unit's
    pictures drained before the next is sent: api.get_picture then
    never parses ahead, so no two frames are ever in flight); one
    warm-up each, then PIPELINE_ROUNDS walls each, the cases in turns
    (in order, reversed, in order), every decode with utils.timing on
    (its spans do not wait for the device), on MD5S_S31 and MD5_S31 and
    on a pipeline of the depth asked for (the decoder's pipeline.depth);
    the launch counts of each case's first counted decode (every
    main-path kernel > 0); per case the median, min, max and spread
    (max - min) of the walls and the medians of the blocked ms that the
    recorder's spans hold: `pipeline.submit_wait` (the caller's thread
    in ReconPipeline.submit_split while `depth` frames are in flight),
    `pipeline.ref_wait` (Stage-B workers blocked on their references'
    promises), `api.wait` (get_picture blocked on the oldest output).
    The winner: the depth of the lowest median wall that beats depth
    1's median by more than the larger of the two spreads, else 1
    (decoder.DEFAULT_STAGEB_DEPTH is set from it). Then whole s33 (4 pictures) at the default depth in
    bench.py's loop on MD5S_S33_WHOLE and MD5_S33_WHOLE: its wall,
    blocked ms and launches."""
    from dav1d_tpu_torch.decoder import DEFAULT_STAGEB_DEPTH, stageb_depth
    default = stageb_depth(0, False)
    # (name, depth asked for (0: the default, max_frame_delay 0), loop)
    cases = [(str(d), d, True) for d in PIPELINE_DEPTHS] + \
        [("cli_loop", 0, False)]
    waits = {"submit_wait_ms": "pipeline.submit_wait",
             "ref_wait_ms": "pipeline.ref_wait", "api_wait_ms": "api.wait"}
    per = {name: {"wall_ms": [], **{k: [] for k in waits}}
           for name, _, _ in cases}
    launches = {}

    def decode(path, d, feed_ahead, md5s_want, md5_want):
        env = {"DAV1D_TPU_STAGEB_DEPTH": str(d)} if d else {}
        depths = []
        with _env(env):
            _, digest, wall, stages, md5s = _decode(
                path, timed=True, max_frame_delay=d, feed_ahead=feed_ahead,
                depths=depths)
        depth = d or default
        if md5s != md5s_want or digest != md5_want:
            raise AssertionError(f"pipeline {path} depth {depth}: md5s "
                                 f"{md5s} {digest}")
        if depths != [depth]:
            raise AssertionError(f"pipeline {path}: not at depth {depth}")
        return wall, {k: stages.get(label, 0.0)
                      for k, label in waits.items()}

    def counted(fn):
        _counts_reset()
        out = fn()
        n = _counts()
        for k in MAIN_KERNELS:
            if n[k] == 0:
                raise AssertionError(f"pipeline: the {k} kernel never "
                                     f"launched")
        return out, n

    def s31(d, feed_ahead):
        return decode(STREAM_1080P, d, feed_ahead, MD5S_S31, MD5_S31)

    for _, d, feed_ahead in cases:
        s31(d, feed_ahead)
    for r in range(PIPELINE_ROUNDS):
        for name, d, feed_ahead in cases[::1 if r % 2 == 0 else -1]:
            if r == 0:
                (wall, w), launches[name] = counted(
                    lambda: s31(d, feed_ahead))
            else:
                wall, w = s31(d, feed_ahead)
            per[name]["wall_ms"].append(wall)
            for k, v in w.items():
                per[name][k].append(v)
    (s33_wall, s33_w), s33_launches = counted(
        lambda: decode(STREAM_4K10, 0, True, MD5S_S33_WHOLE, MD5_S33_WHOLE))
    out = {}
    for name, r in per.items():
        walls = r["wall_ms"]
        out[name] = {
            "wall_ms": walls, "wall_ms_median": _median(walls),
            "wall_ms_min": min(walls), "wall_ms_max": max(walls),
            "spread_ms": max(walls) - min(walls),
            "fps_median": 1e3 * len(MD5S_S31) / _median(walls),
            **{f"{k}_median": _median(v) for k, v in r.items()
               if k != "wall_ms"},
            "launches": launches[name]}
    base = out["1"]
    beat = [d for d in PIPELINE_DEPTHS[1:]
            if base["wall_ms_median"] - out[str(d)]["wall_ms_median"] >
            max(base["spread_ms"], out[str(d)]["spread_ms"])]
    winner = min(beat, key=lambda d: out[str(d)]["wall_ms_median"]) \
        if beat else 1
    emit({"phase": "pipeline", "card": card, "stream": STREAM_1080P,
          "pictures": len(MD5S_S31), "rounds": PIPELINE_ROUNDS,
          "depths": {str(d): out[str(d)] for d in PIPELINE_DEPTHS},
          "cli_loop": {"depth": default, **out["cli_loop"]},
          "winner": winner, "default_depth": DEFAULT_STAGEB_DEPTH,
          "s33_whole": {"stream": STREAM_4K10,
                        "pictures": len(MD5S_S33_WHOLE), "depth": default,
                        "wall_ms": s33_wall, **s33_w,
                        "launches": s33_launches}})


def _itx_check_work(plan):
    """The work of itx_sharded_check on `plan`: its largest bucket (B
    blocks of one transform) through the residual kernel twice, the
    shards' parts and the whole bucket on one device, each a call of
    _itx_work (coefficients and job rows read once, each block's pixels
    read and written once); {tx, blocks, bytes, ops, bound_ms,
    bound_by}."""
    import numpy as np
    from dav1d_tpu_torch.parallel.sharded import _itx_bucket
    tx, _, offs, _ = _itx_bucket(plan)
    jobs = np.zeros((len(offs), 6), np.int64)
    jobs[:, 0] = tx
    b, o = _itx_work(jobs, False)
    bound = _bound(2 * b, 2 * o)
    return {"tx": tx, "blocks": len(offs), "bytes": 2 * b, "ops": 2 * o,
            "bound_ms": bound[0], "bound_by": bound[1]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs one GPU",
              file=sys.stderr)
        return 1
    import dav1d_tpu_torch  # noqa: F401  (fails outside a checkout)
    card = smi()
    phase_device(torch)
    ptxas = phase_build()
    lines = {k: {} for k in KERNELS}
    lines["deblock"].update(phase_kernel(torch, card))
    for k, e in phase_kernel_mc(torch, card).items():
        lines[k]["max_abs_err"] = e
    lines["itx_add"]["max_abs_err"] = phase_kernel_itx(torch, card)
    for k, e in phase_kernel_warp_obmc(torch, card).items():
        lines[k]["max_abs_err"] = e
    for k, e in phase_kernel_filters(torch, card).items():
        lines[k]["max_abs_err"] = e
    for k, r in phase_kernel_superres_grain(torch, card).items():
        lines[k].update(r)
    lines["ipred"].update(phase_kernel_ipred(torch, card,
                                             ptxas.get("ipred")))
    for args in ((), (STREAM_4K10, MD5S_S33, MAIN_KERNELS[1:]),  # s7, s33,
                 (STREAM_1080P, MD5S_S31, MAIN_KERNELS[1:])):    # s31
        for k, r in phase_kernel_real(torch, card, *args).items():
            # the kernels line keeps the main path's frame: s31's, last
            lines[k].update({f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                                "bound_by")})
            lines[k]["max_abs_err"] = max(lines[k]["max_abs_err"],
                                          r["max_abs_err"])
    phase_stream(torch, "slice", STREAM_1080P, MD5_1080P, (1152, 1920),
                 "uint8", need=("deblock",) + FILTER_KERNELS, frame_type=3)
    phase_stream(torch, "hbd", STREAM_4K10, MD5_4K10, (2176, 3840),
                 "uint16", need=("deblock",) + FILTER_KERNELS, frame_type=3)
    phase_stream(torch, "inter", STREAM_S7, MD5_S7, (1152, 1920), "uint8",
                 pic_md5s=MD5S_S7, need=KERNELS_NO_WARP,
                 repeats=INTER_REPEATS)
    phase_stream(torch, "inter_hbd", STREAM_S11, MD5_S11, (2176, 3840),
                 "uint16", pic_md5s=MD5S_S11, need=KERNELS_NO_WARP,
                 repeats=INTER_REPEATS, n_tu=2)
    launches = phase_stream(torch, "inter_main", STREAM_1080P, MD5_S31,
                            (1152, 1920), "uint8", pic_md5s=MD5S_S31,
                            need=MAIN_KERNELS, repeats=INTER_REPEATS)
    for k in MAIN_KERNELS:             # the main path: s31
        lines[k]["launches"] = launches[k]
    phase_stream(torch, "inter_main_hbd", STREAM_4K10, MD5_S33,
                 (2176, 3840), "uint16", pic_md5s=MD5S_S33,
                 need=MAIN_KERNELS, repeats=INTER_REPEATS, n_tu=2)
    phase_golden_walks(torch)
    phase_collector(torch, card)
    phase_sharded(torch, card)
    # the leftovers' own path: s31 with DAV1D_TPU_LO=device (the port's
    # default keeps them on the host route)
    lines["ipred"]["launches"] = phase_leftovers(torch, card)
    # s31 runs neither super-res nor film grain: their launches come
    # from the streams of their own phases
    for name, (pic_md5s, md5) in BIG_POST_FILTERS.items():
        k = _post_filter_kernel(name)
        hbd = name.endswith("10b")
        launches = phase_stream(
            torch, name, f"{GOLDEN_DIR}/{name}.ivf", md5, (1152, 1920),
            "uint16" if hbd else "uint8", pic_md5s=pic_md5s,
            need=("deblock",) + FILTER_KERNELS + (k,),
            repeats=INTER_REPEATS)
        if name in ("sr-1080p", "fg-1080p"):
            lines[k]["launches"] = launches[k]
    phase_post_filters(torch)
    phase_golden_route(torch, card)
    phase_mc_batch(torch, card)
    phase_pipeline(torch, card)
    sources = {"deblock": ("dav1d_tpu_torch/csrc/deblock.cu",
                           "dav1d_tpu/ops/lf_pallas.py:74"),
               "mc_put": ("dav1d_tpu_torch/csrc/mc_put.cu",
                          "dav1d_tpu/ops/mc_pallas.py:41"),
               "mc_comp": ("dav1d_tpu_torch/csrc/mc_comp.cu",
                           "dav1d_tpu/ops/mc_fused.py:626"),
               "itx_add": ("dav1d_tpu_torch/csrc/itx_add.cu",
                           "dav1d_tpu/ops/mc_fused.py:733"),
               "mc_warp": ("dav1d_tpu_torch/csrc/mc_warp.cu",
                           "dav1d_tpu/ops/mc_fused.py:537"),
               "mc_obmc": ("dav1d_tpu_torch/csrc/mc_obmc.cu",
                           "dav1d_tpu/ops/mc_fused.py:576"),
               "cdef": ("dav1d_tpu_torch/csrc/cdef.cu",
                        "dav1d_tpu/ops/cdef.py:59"),
               "lr_wiener": ("dav1d_tpu_torch/csrc/lr_wiener.cu",
                             "dav1d_tpu/ops/lr.py:106"),
               "lr_sgr": ("dav1d_tpu_torch/csrc/lr_sgr.cu",
                          "dav1d_tpu/ops/lr.py:146"),
               "superres": ("dav1d_tpu_torch/csrc/superres.cu",
                            "dav1d_tpu/ops/superres.py:41"),
               "film_grain": ("dav1d_tpu_torch/csrc/film_grain.cu",
                              "dav1d_tpu/ops/fg.py:131"),
               "ipred": ("dav1d_tpu_torch/csrc/ipred.cu",
                         "dav1d_tpu/ops/ipred.py:50")}
    # library_ms is null for every kernel: no single PyTorch call
    # computes a deblock pass, a clamped-window 8-tap put, a masked
    # compound, an integer AV1 inverse transform, an affine-warped 8x8
    # tile, an OBMC lap blend, a CDEF direction search and constrained
    # filter, a Wiener filter over row-table windows, a self-guided
    # filter with its x_by_x lookup, a super-res upscale with its
    # per-column phases or a film grain synthesis with its LUT gathers
    # and overlap blends, or a frame's levels of intra predictions from
    # edge runs and their residuals (film_grain also replaces
    # dav1d_tpu/ops/fg.py:172, the chroma
    # program; ipred the other seven programs of dav1d_tpu/ops/ipred.py)
    emit({"kernels": [{
        "name": k, "route": "cuda", "source": sources[k][0],
        "replaces": sources[k][1], **{f: lines[k][f] for f in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")}, "library_ms": None} for k in KERNELS]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
