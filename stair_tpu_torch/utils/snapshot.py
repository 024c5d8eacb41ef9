"""Reproducibility snapshot: copy the framework source into the run dir.

Equivalent of the reference's ``backup_code`` (yellow-binary-tree/STAIR
``train_module.py:22-30``), plus a git-state record when available. The
port's own copy of ``stair_tpu/utils/snapshot.py``: it copies
``stair_tpu_torch`` and leaves out built libraries and the kernel build
directory.
"""

from __future__ import annotations

import os
import shutil
import subprocess


def backup_code(output_dir: str) -> str:
    """Copy the stair_tpu_torch package (and entry scripts) into <output>/code."""
    import stair_tpu_torch

    src_root = os.path.dirname(os.path.abspath(stair_tpu_torch.__file__))
    dest = os.path.join(output_dir, "code")
    pkg_dest = os.path.join(dest, "stair_tpu_torch")
    if os.path.exists(pkg_dest):
        shutil.rmtree(pkg_dest)
    shutil.copytree(
        src_root, pkg_dest,
        ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.pyc", "build"),
    )
    # Record git state for exact reproducibility.
    try:
        repo_root = os.path.dirname(src_root)
        head = subprocess.run(
            ["git", "-C", repo_root, "rev-parse", "HEAD"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        diff = subprocess.run(
            ["git", "-C", repo_root, "diff", "HEAD"],
            capture_output=True, text=True, check=True,
        ).stdout
        with open(os.path.join(dest, "GIT_STATE"), "w") as f:
            f.write(head + "\n")
            if diff:
                f.write("\n--- uncommitted diff ---\n" + diff)
    except Exception:
        pass
    return dest
