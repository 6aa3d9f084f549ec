#!/usr/bin/env python
"""Repo-root bench entry point: ``python bench.py`` runs the full
per-config table (wavelets_tpu/evidence.py) on the attached GPU and
emits it inside one JSON line.  The implementation lives in
wavelets_tpu.bench so the installed console script
(``wavelets-tpu bench``, headline rows only) works outside the
checkout too."""

from wavelets_tpu.bench import main_table

if __name__ == "__main__":
    main_table()
