"""The card check's planted faults, on the CPU.

``chip_smoke.py`` plants each fault of ``FAULTS`` (CUDA sources) and
``TRITON_FAULTS`` (Triton kernel functions) by replacing a sound text with
a planted one, and its build phase refuses a source that lost the sound
text, but only on the card, after the builds.  Here every fault's sound
text must occur exactly once in the source it is planted in, and the
planted text must differ from it, so a kernel edit that moves an anchor
shows before a card run.  Runs without a card:

    PYTHONPATH=src python -m pytest tests/test_torch_faults.py
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _chip_smoke()


@pytest.mark.parametrize("fault", [*chip_smoke.FAULTS,
                                   *chip_smoke.TRITON_FAULTS])
def test_planted_fault_anchor_is_unique(fault):
    src, sound, planted = chip_smoke.fault_source(fault)
    assert src.count(sound) == 1, (fault, src.count(sound))
    assert planted != sound
    assert src.replace(sound, planted) != src

