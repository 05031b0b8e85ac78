"""A run of the harness, past its look for a card, with the program broken
underneath: each fault the cells can have makes ``correct`` false. (The
cells take one chip each, so there is no exchange between chips to
leave out.)"""
import pytest
import torch

from mdbench import harness
from helpers import run_small, small_cell


def _step_returns_state(force_fn, masses, dt, friction, kT):
    return lambda state: state._replace(step=state.step + 1)


def _half_batch(original):
    def fused(params, aev, counts):
        half = tuple(c // 2 for c in counts)
        starts = [sum(counts[:s]) for s in range(len(counts))]
        rows = torch.cat([aev[a:a + h] for a, h in zip(starts, half)])
        return original(params, rows, half) * (sum(counts) / sum(half))
    return fused


def _altered_force(original):
    def call(self, *args, **kwargs):
        e, f = original(self, *args, **kwargs)
        atom = int(torch.argmax(torch.abs(f).max(1).values))
        f = f.clone()
        f[atom] = -f[atom]
        return e, f
    return call


def _fault(name, config, monkeypatch):
    from nnpops_tpu_torch.md import integrators
    from nnpops_tpu_torch.models import ani, combined
    model = {'ani2x': ani.ANIModel, 'ani2x_pme': combined.ANIWithPME}[config]
    if name == 'state_unchanged':
        monkeypatch.setattr(integrators, 'langevin_baoab',
                            _step_returns_state)
    elif name == 'half_batch':
        monkeypatch.setattr(ani, 'ensemble_energy_grouped_rows_fused',
                            _half_batch(
                                ani.ensemble_energy_grouped_rows_fused))
    elif name == 'answer_altered':
        monkeypatch.setattr(
            model, 'energy_and_forces_from_selection',
            _altered_force(model.energy_and_forces_from_selection))


@pytest.mark.parametrize('config', ['ani2x', 'ani2x_pme'])
@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch',
                                   'answer_altered'])
def test_fault_makes_run_incorrect(fault, config, monkeypatch):
    cfg, tr = small_cell(config)
    _fault(fault, config, monkeypatch)
    out = run_small(cfg, tr, 2 ** 33 + 41)
    correct, checks = harness.verdict(cfg, out)
    assert not correct, (fault, checks)
