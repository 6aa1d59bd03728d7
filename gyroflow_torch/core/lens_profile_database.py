"""Lens profile database.

Port of gyroflow src/core/lens_profile_database.rs: loads bundled +
user-downloaded profile JSONs, fuzzy search, identifier-based autoload lookup.
The reference fetches its database from GitHub (controller.rs:1923); here any
directory of the same JSON files works (GYROFLOW_TPU_LENS_DB or
~/.config/gyroflow-tpu/lens_profiles).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

from .lens_profile import LensProfile

log = logging.getLogger(__name__)


def default_db_paths() -> List[str]:
    paths = []
    env = os.environ.get("GYROFLOW_TPU_LENS_DB")
    if env:
        paths.append(env)
    paths.append(os.path.join(os.path.expanduser("~"), ".config",
                              "gyroflow-tpu", "lens_profiles"))
    bundled = os.path.join(os.path.dirname(__file__), "..", "resources",
                           "camera_presets")
    paths.append(os.path.abspath(bundled))
    return paths


class LensProfileDatabase:
    def __init__(self, paths: Optional[List[str]] = None):
        self.paths = paths or default_db_paths()
        self.profiles: Dict[str, LensProfile] = {}   # path -> profile
        self.loaded = False

    def load_all(self):
        """lens_profile_database.rs:71+."""
        for root in self.paths:
            if not os.path.isdir(root):
                continue
            for dirpath, _dirs, files in os.walk(root):
                for fn in files:
                    if not fn.endswith(".json"):
                        continue
                    full = os.path.join(dirpath, fn)
                    try:
                        p = LensProfile.load_from_file(full)
                        if p.is_valid():
                            self.profiles[full] = p
                    except (json.JSONDecodeError, OSError, ValueError) as e:
                        log.debug("skipping %s: %s", full, e)
        self.loaded = True
        log.info("lens database: %d profiles", len(self.profiles))

    def _ensure(self):
        if not self.loaded:
            self.load_all()

    def get_all_names(self) -> List[str]:
        self._ensure()
        return sorted(self.display_name(p) for p in self.profiles.values())

    @staticmethod
    def display_name(p: LensProfile) -> str:
        parts = [p.camera_brand, p.camera_model, p.lens_model, p.camera_setting,
                 f"{p.calib_dimension.w}x{p.calib_dimension.h}"]
        return " ".join(x for x in parts if x)

    def search(self, query: str, limit: int = 50) -> List[LensProfile]:
        """Case-insensitive all-terms substring search (database `search`)."""
        self._ensure()
        terms = query.lower().split()
        out = []
        for p in self.profiles.values():
            hay = (self.display_name(p) + " " + p.identifier + " " + p.name).lower()
            if all(t in hay for t in terms):
                out.append(p)
                if len(out) >= limit:
                    break
        return out

    def find_by_identifier(self, identifier: str) -> Optional[LensProfile]:
        """Autoload lookup (lib.rs:1929-1956 uses CameraIdentifier ids)."""
        if not identifier:
            return None
        self._ensure()
        for p in self.profiles.values():
            if p.identifier and p.identifier.lower() == identifier.lower():
                return p
        # relaxed: match ignoring the trailing "additional" segment
        base = identifier.rsplit("-", 1)[0]
        for p in self.profiles.values():
            if p.identifier and p.identifier.lower().startswith(base):
                return p
        return None

    def add_profile(self, profile: LensProfile, save_dir: Optional[str] = None) -> str:
        save_dir = save_dir or self.paths[-2]
        os.makedirs(save_dir, exist_ok=True)
        fn = (profile.name or "profile").replace(" ", "_").replace("/", "_") + ".json"
        full = os.path.join(save_dir, fn)
        with open(full, "w") as f:
            json.dump(profile.to_dict(), f, indent=2)
        self.profiles[full] = profile
        return full
