"""Each fault a cell can have, planted under its timed path, turns
``correct`` false; the harness's look for a card is skipped (the CPU runs
the program's plain versions)."""

import importlib

import pytest
import torch

from benchmark.tests.conftest import run_tiny

cgls_mod = importlib.import_module("tomojax_torch.recon.cgls")
slab = importlib.import_module("tomojax_torch.core.slab_projector")
cc = importlib.import_module("tomojax_torch.align.cc")


def _state_unchanged(monkeypatch):
    real = cgls_mod.cgls_steps

    def steps(op, b, state, **kw):
        new, conv, rms = real(op, b, state, **kw)
        return (type(state)(**{**vars(state), "k": new.k}), conv, rms)
    monkeypatch.setattr(cgls_mod, "cgls_steps", steps)


def _half_the_views(monkeypatch):
    """The adjoint sums the even views only, twice over (the mean over
    the rest)."""
    real = slab.backproject_scalars

    def back(sino, *a, **kw):
        keep = sino.clone().reshape(sino.shape[0], -1)
        keep[1::2] = 0.0
        return 2.0 * real(keep, *a, **kw)
    monkeypatch.setattr(slab, "backproject_scalars", back)


def _answer_altered(monkeypatch):
    """One view's row of the forward is off by 1%."""
    real = slab.project_scalars

    def fwd(*a, **kw):
        out = real(*a, **kw).clone()
        out[3] *= 1.01
        return out
    monkeypatch.setattr(slab, "project_scalars", fwd)


def _chain_unchanged(monkeypatch):
    """The chain returns the views unshifted."""
    monkeypatch.setattr(cc, "fourier_shift", lambda img, s, **kw: img)


def _half_the_registrations(monkeypatch):
    """Every other view is left unregistered (offset 0)."""
    real = cc.phase_cross_correlation
    calls = [0]

    def pcc(ref, mov, **kw):
        calls[0] += 1
        s = real(ref, mov, **kw)
        return s if calls[0] % 2 else torch.zeros_like(s)
    monkeypatch.setattr(cc, "phase_cross_correlation", pcc)


def _offset_altered(monkeypatch):
    """One registration's offset is off by half a pixel."""
    real = cc.phase_cross_correlation
    calls = [0]

    def pcc(ref, mov, **kw):
        calls[0] += 1
        s = real(ref, mov, **kw)
        return s + 0.5 if calls[0] % 23 == 5 else s
    monkeypatch.setattr(cc, "phase_cross_correlation", pcc)


CGLS_FAULTS = [_state_unchanged, _half_the_views, _answer_altered]
CC_FAULTS = [_chain_unchanged, _half_the_registrations, _offset_altered]


@pytest.mark.parametrize("workload", ["c5.cgls", "c5.cgls_bf16"])
@pytest.mark.parametrize("fault", CGLS_FAULTS, ids=lambda f: f.__name__[1:])
def test_cgls_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert run_tiny(workload)["correct"] is False


@pytest.mark.parametrize("fault", CC_FAULTS, ids=lambda f: f.__name__[1:])
def test_chain_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert run_tiny("c5.prealign")["correct"] is False
