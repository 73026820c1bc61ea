"""The seeded weights, the checks' inputs and the stored work stay bit for
bit what ``data/weights_and_work.json`` records: the digest of each
configuration's weight table (models, keys, shapes, in the order they are
drawn), the tiny configuration's draws (each model's digest and first
values) and the program's and the reference's models filled from them,
and the bytes of every work file it lists. The record was taken before the
models were built through a configuration's architecture file; a change
that means to move any of these writes a new record and says why."""
import hashlib
import json
import os

import pytest

from port_bench.lib import names, port, weights

RECORD = names.read_json(os.path.join(os.path.dirname(__file__), "data",
                                      "weights_and_work.json"))
SEED = RECORD["seed"]
ENCODER = ["False", "True"]


def shapes_digest(table: weights.Shapes) -> str:
    return hashlib.sha256(json.dumps(
        [[m, [[k, list(s)] for k, s in keys.items()]] for m, keys in table.items()]
    ).encode()).hexdigest()


def tensors_digest(state: dict) -> str:
    h = hashlib.sha256()
    for k, t in state.items():
        h.update(k.encode())
        h.update(t.detach().to("cpu").contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(RECORD["shapes"]))
def test_weight_tables(config):
    cfg = names.config(config)
    assert {enc: shapes_digest(port.weight_table(cfg, enc == "True"))
            for enc in ENCODER} == RECORD["shapes"][config]


@pytest.mark.parametrize("enc", ENCODER)
def test_tiny_draws_and_filled_models(enc):
    tiny = names.config("tiny-cpu")
    draws = {}
    for model, state in weights.draw(port.weight_table(tiny, enc == "True"),
                                     names.derive(SEED, "weights"), "cpu",
                                     port.weight_dtype(tiny)):
        first = next(iter(state.values()))
        draws[model] = {"sha256": tensors_digest(state), "first": first.flatten()[:8].tolist()}
    assert draws == RECORD["draws"][enc]
    prog = port.build_modules(tiny, SEED, "cpu", vae_encoder=enc == "True")
    assert {m: tensors_digest(getattr(prog, m).state_dict())
            for m in RECORD["program"][enc]} == RECORD["program"][enc]
    ref = port.reference_modules(tiny, SEED, "cpu", vae_encoder=enc == "True")
    assert {m: tensors_digest(mod.state_dict()) for m, mod in ref.items()} == \
        RECORD["reference"][enc]


def test_work_files():
    for name, digest in RECORD["work"].items():
        with open(os.path.join(names.BENCH_DIR, "work", name), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == digest, name
