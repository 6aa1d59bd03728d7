"""Merge companion .gcsv logs of a chaptered recording into one file.

Port of the merge path in gyroflow src/controller.rs:2248-2353
(`merge_gcsv`, part of the mp4_merge flow): for each input file (video or
.gcsv path) the sibling .gcsv is appended to the output with its timestamps
continued past the previous chapter's end, and an `additional_sync_points`
header records timestamps around each join so autosync can re-estimate the
offset there. Timestamp continuation is skipped when the logs already share
one continuous clock (reference `do_add_timestamp`).

The reference's MP4 container merge itself lives in the external `mp4-merge`
crate; this module covers the telemetry half, which is what the stabilizer
consumes.
"""
from __future__ import annotations

import os
import re
from typing import List, Tuple


def natural_sorted(names) -> List[str]:
    """human_sort equivalent: digit runs compare numerically (clip2 < clip10)."""
    def key(s):
        return [int(t) if t.isdigit() else t.lower()
                for t in re.split(r"(\d+)", s)]
    return sorted(names, key=key)


def _gcsv_path(path: str) -> str:
    base, ext = os.path.splitext(path)
    return path if ext.lower() == ".gcsv" else base + ".gcsv"


def _scan(path: str) -> Tuple[List[str], List[str], float, float, float]:
    """Returns (header_lines, data_lines, tscale, first_ts, last_ts)."""
    headers: List[str] = []
    data: List[str] = []
    tscale = 0.001
    first_ts = last_ts = 0.0
    is_data = False
    with open(path, "r") as fh:
        for i, line in enumerate(fh):
            line = line.rstrip("\n")
            if i == 0 and "GYROFLOW IMU LOG" not in line \
                    and "CAMERA IMU LOG" not in line:
                raise IOError(f"not a .gcsv file: {path}")
            if not is_data:
                if line.startswith("tscale,"):
                    try:
                        tscale = float(line.split(",", 1)[1])
                    except ValueError:
                        pass
                headers.append(line)
                if line.startswith(("t,", "time,")):
                    is_data = True
            elif "," in line:
                data.append(line)
    if data:
        try:
            first_ts = float(data[0].split(",", 1)[0])
            last_ts = float(data[-1].split(",", 1)[0])
        except ValueError:
            pass
    return headers, data, tscale, first_ts, last_ts


def merge_gcsv(file_list: List[str], output_path: str) -> List[float]:
    """Merge the .gcsv companions of `file_list` into `output_path`.

    Returns the additional sync points (ms) written to the header (empty
    when fewer than two logs merge). Inputs may be video paths (the sibling
    .gcsv is used) or .gcsv paths directly; missing companions are skipped
    like the reference's exists_in_folder gate."""
    scans = []
    for x in file_list:
        p = _gcsv_path(x)
        if os.path.exists(p):
            scans.append(_scan(p))
    if not scans:
        raise IOError("no .gcsv companions found to merge")

    # reference do_add_timestamp: only re-base timestamps when some chapter
    # restarts its clock (timestamp goes backwards across the whole set)
    do_add = False
    prev = None
    for (_h, data, _ts, first, _last) in scans:
        for ln in data:
            try:
                t = float(ln.split(",", 1)[0])
            except ValueError:
                continue
            if prev is not None and t < prev:
                do_add = True
                break
            prev = t
        if do_add:
            break

    headers, _d0, time_scale, _f0, _l0 = scans[0]
    sync_points: List[float] = []
    out_data: List[str] = []
    add_timestamp = 0.0
    for fi, (_h, data, tscale, first, last) in enumerate(scans):
        if fi > 0:
            # join time on the MERGED clock: rebase offset + the chapter's own
            # first timestamp (the reference uses add_timestamp alone, which
            # is 0 for already-continuous clocks and lands the points at t=0)
            base_ms = (add_timestamp + first) * time_scale * 1000.0
            sync_points += [base_ms - 500.0, base_ms + 500.0, base_ms + 1000.0,
                            base_ms + 2000.0, base_ms + 2500.0]
        last_diff = 0.0
        last_timestamp = 0.0
        for ln in data:
            head, _, rest = ln.partition(",")
            try:
                t = float(head)
            except ValueError:
                out_data.append(ln)
                continue
            last_diff = t - last_timestamp
            last_timestamp = t
            nt = t + add_timestamp
            # Shortest round-trip f64 formatting (repr), matching the
            # reference's new_timestamp.to_string() (controller.rs:2331).
            # '%g' keeps only 6 significant digits, which quantizes any
            # timestamp >= 1e6 ticks and destroys sample ordering.
            nt_s = repr(nt)
            if nt_s.endswith(".0"):
                nt_s = nt_s[:-2]
            out_data.append(f"{nt_s},{rest}" if rest else nt_s)
        if do_add:
            add_timestamp += last_timestamp + last_diff

    with open(output_path, "w") as fh:
        for line in headers[:-1]:
            fh.write(line + "\n")
        if sync_points:
            fh.write("additional_sync_points,"
                     + ";".join(f"{x:.3f}" for x in sync_points) + "\n")
        fh.write(headers[-1] + "\n")        # the t,gx,... column header
        for line in out_data:
            fh.write(line + "\n")
    return sync_points
