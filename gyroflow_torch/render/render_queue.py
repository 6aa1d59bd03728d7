"""Multi-job render queue.

Port of gyroflow src/render_queue.rs essentials: job list with status,
pause/cancel, parallel renders (thread pool — each job gets its own cloned
manager, lib.rs:1168), queue persistence for resume.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional

from .renderer import RenderOptions, render

log = logging.getLogger(__name__)


class JobStatus(str, Enum):
    Queued = "queued"
    Rendering = "rendering"
    Finished = "finished"
    Error = "error"
    Cancelled = "cancelled"


@dataclass
class RenderJob:
    job_id: int
    input_file: str
    output_file: str
    project_data: Optional[str] = None      # exported .gyroflow JSON
    options: RenderOptions = field(default_factory=RenderOptions)
    status: JobStatus = JobStatus.Queued
    progress: float = 0.0
    error: Optional[str] = None
    cancel_flag: list = field(default_factory=lambda: [False])
    pause_flag: list = field(default_factory=lambda: [False])


class RenderQueue:
    def __init__(self, parallel_renders: int = 1, state_path: Optional[str] = None):
        self.jobs: Dict[int, RenderJob] = {}
        self._next_id = 1
        self.parallel_renders = max(parallel_renders, 1)
        self.state_path = state_path
        self._lock = threading.Lock()
        self.paused = False

    def add_job(self, mgr, input_file: str, output_file: str,
                options: Optional[RenderOptions] = None) -> int:
        from ..core.project_file import GyroflowProjectType, export_gyroflow_data
        opts = options or RenderOptions()
        # persist the render-output settings in the project blob like the
        # reference queue (render_queue.rs get_render_options -> "output")
        output = {
            "codec": opts.codec, "bitrate": opts.bitrate,
            "output_width": opts.output_width, "output_height": opts.output_height,
            "use_gpu": opts.use_gpu, "audio": opts.audio,
            "pixel_format": opts.pix_fmt,
            "output_folder": os.path.dirname(os.path.abspath(output_file)),
            "output_filename": os.path.basename(output_file),
            # advanced settings (render_queue.rs:82-90)
            "encoder_options": opts.encoder_options,
            "keyframe_distance": opts.keyframe_distance,
            "preserve_other_tracks": opts.preserve_other_tracks,
            "pad_with_black": opts.pad_with_black,
            "export_trims_separately": opts.export_trims_separately,
            "audio_codec": opts.audio_codec,
            "interpolation": opts.interpolation,
            "metadata": {"comment": opts.metadata_comment},
        }
        with self._lock:
            job_id = self._next_id
            self._next_id += 1
            self.jobs[job_id] = RenderJob(
                job_id=job_id, input_file=input_file, output_file=output_file,
                project_data=export_gyroflow_data(
                    mgr, GyroflowProjectType.WithGyroData,
                    additional_data={"output": output}),
                options=opts)
        self.save_state()
        return job_id

    def cancel_job(self, job_id: int):
        job = self.jobs.get(job_id)
        if job:
            job.cancel_flag[0] = True
            job.status = JobStatus.Cancelled

    def pause(self):
        """Suspend all running renders mid-frame-loop (render_queue.rs
        pause_flag, :614-694); queued jobs also wait before starting."""
        self.paused = True
        for j in self.jobs.values():
            j.pause_flag[0] = True

    def resume(self):
        self.paused = False
        for j in self.jobs.values():
            j.pause_flag[0] = False

    def run(self, overwrite: bool = False,
            progress_cb: Optional[Callable[[int, float], None]] = None):
        """Render all queued jobs, `parallel_renders` at a time."""
        def run_job(job: RenderJob):
            from ..core.manager import StabilizationManager
            from ..core.project_file import import_gyroflow_data
            try:
                if os.path.exists(job.output_file) and not overwrite:
                    raise FileExistsError(f"{job.output_file} exists (use overwrite)")
                mgr = StabilizationManager()
                if job.project_data:
                    import_gyroflow_data(mgr, job.project_data)
                job.status = JobStatus.Rendering

                def cb(p):
                    job.progress = p
                    if progress_cb:
                        progress_cb(job.job_id, p)
                import time as _t
                while self.paused and not job.cancel_flag[0]:
                    _t.sleep(0.1)        # queue paused before the job started
                render(mgr, job.input_file, job.output_file, job.options,
                       progress_cb=cb, cancel_flag=job.cancel_flag,
                       pause_flag=job.pause_flag)
                if job.cancel_flag[0]:
                    job.status = JobStatus.Cancelled
                else:
                    job.status = JobStatus.Finished
                    job.progress = 1.0
            except Exception as e:  # noqa: BLE001 — job isolation
                log.exception("render job %s failed", job.job_id)
                job.status = JobStatus.Error
                job.error = str(e)
            self.save_state()

        queued = [j for j in self.jobs.values() if j.status == JobStatus.Queued]
        with ThreadPoolExecutor(max_workers=self.parallel_renders) as pool:
            list(pool.map(run_job, queued))

    # ---- persistence (render_queue.rs:713-776) -----------------------------

    def save_state(self):
        if not self.state_path:
            return
        # worker threads save on status changes: serialize writers and swap
        # atomically so a concurrent load never sees interleaved JSON
        with self._lock:
            import dataclasses

            def opts_json(o):
                d = dataclasses.asdict(o)
                d.pop("overlay", None)   # in-memory debug object, not state
                return d

            state = [{
                "job_id": j.job_id, "input_file": j.input_file,
                "output_file": j.output_file, "project_data": j.project_data,
                "status": j.status.value, "progress": j.progress, "error": j.error,
                "options": opts_json(j.options),
            } for j in self.jobs.values()]
            tmp = self.state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, self.state_path)

    @classmethod
    def load_state(cls, state_path: str, parallel_renders: int = 1) -> "RenderQueue":
        q = cls(parallel_renders, state_path)
        if os.path.exists(state_path):
            with open(state_path) as f:
                for j in json.load(f):
                    job = RenderJob(job_id=j["job_id"], input_file=j["input_file"],
                                    output_file=j["output_file"],
                                    project_data=j.get("project_data"))
                    opts = RenderOptions()
                    for k, v in (j.get("options") or {}).items():
                        if hasattr(opts, k):
                            setattr(opts, k, v)
                    job.options = opts
                    job.status = JobStatus(j.get("status", "queued"))
                    if job.status == JobStatus.Rendering:
                        job.status = JobStatus.Queued  # resume interrupted
                    job.progress = j.get("progress", 0.0)
                    q.jobs[job.job_id] = job
                    q._next_id = max(q._next_id, job.job_id + 1)
        return q
