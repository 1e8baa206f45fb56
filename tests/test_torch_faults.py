"""The card check's planted faults, on the CPU.

``chip_smoke.py`` plants each fault of ``FAULTS`` (CUDA sources) and
``TRITON_FAULTS`` (Triton kernel functions) by replacing a sound text with
a planted one, and its build phase refuses a source that lost the sound
text, but only on the card, after the builds.  Here every fault's sound
text must occur exactly once in the source it is planted in, and the
planted text must differ from it, so a kernel edit that moves an anchor
shows before a card run.  The same holds for the probes and variants two
examples build from the Hopper flash kernel's source
(``examples/torch_hybrid_loss_noise.py``, ``examples/torch_flash_depths.py``).
Runs without a card:

    PYTHONPATH=src python -m pytest tests/test_torch_faults.py
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
loss_noise = _load("torch_hybrid_loss_noise",
                   ROOT / "examples" / "torch_hybrid_loss_noise.py")
flash_depths = _load("torch_flash_depths",
                     ROOT / "examples" / "torch_flash_depths.py")
FLASH_SM90 = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_sm90.cu"


@pytest.mark.parametrize("fault", [*chip_smoke.FAULTS,
                                   *chip_smoke.TRITON_FAULTS])
def test_planted_fault_anchor_is_unique(fault):
    src, sound, planted = chip_smoke.fault_source(fault)
    assert src.count(sound) == 1, (fault, src.count(sound))
    assert planted != sound
    assert src.replace(sound, planted) != src



@pytest.mark.parametrize("probe", [*loss_noise.PROBES])
def test_loss_noise_probe_changes_its_kernel(probe):
    stem, text = loss_noise.probe_sources()[probe]
    assert text != (FLASH_SM90.parent / f"{stem}.cu").read_text()


@pytest.mark.parametrize("variant", [*flash_depths.VARIANTS])
def test_flash_depth_variant_anchors_are_unique(variant):
    src = FLASH_SM90.read_text()
    edits = flash_depths.VARIANTS[variant]
    for sound, _ in edits:
        assert src.count(sound) == 1, (variant, sound)
    assert any(new != sound for sound, new in edits)
