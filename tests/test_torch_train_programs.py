"""The port's training programs (``llama_pjit``, ``vit_train``, ``t5_train``,
``resnet_single``) run in process with ``main(device="cpu")`` under a
monkeypatched pod env: exit 0, the reference program's line with the same
keys in the same order (the reference's ``main()`` runs beside it, in
process, on the 8 virtual CPU devices of ``tests/conftest.py``, so its
``devices`` and mesh read 8 where the port's read 1), finite losses that
fall on the fixed-batch programs, and the refusal branches.
``parse_mesh`` is the reference's, held to it on a table of specs;
``vit_train``'s image batch equals ``jax.random.uniform(PRNGKey(0), ...)``
bit for bit.
"""

import ast
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kubegpu_tpu.workloads.programs import llama_pjit as j_llama
from kubegpu_tpu.workloads.programs import resnet_single as j_resnet
from kubegpu_tpu.workloads.programs import t5_train as j_t5
from kubegpu_tpu.workloads.programs import vit_train as j_vit
from kubegpu_tpu_torch.workloads.programs import llama_pjit, resnet_single
from kubegpu_tpu_torch.workloads.programs import t5_train, vit_train

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
try:
    import chip_smoke
finally:
    sys.path.pop(0)

PROGRAMS = {
    "llama_pjit": (llama_pjit, j_llama, {"LLAMA_STEPS": "3"}),
    "vit_train": (vit_train, j_vit, {"VIT_STEPS": "3"}),
    "t5_train": (t5_train, j_t5, {"T5_STEPS": "3"}),
    "resnet_single": (resnet_single, j_resnet, {"RESNET_STEPS": "3"}),
}
# what a single-card pod's env holds, and nothing of another program
POD_ENV = {"TPU_WORKER_ID": "0", "TPU_VISIBLE_CHIPS": "0"}
CLEARED = ("LLAMA_", "VIT_", "T5_", "RESNET_", "KUBETPU_", "TPU_",
           "JAX_NUM_PROCESSES", "JAX_COORDINATOR_ADDRESS")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 run puts six test processes on the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pod(monkeypatch):
    """A clean pod env; returns a setter for the program's knobs."""
    import os
    for k in list(os.environ):
        if k.startswith(CLEARED):
            monkeypatch.delenv(k)
    for k, v in POD_ENV.items():
        monkeypatch.setenv(k, v)

    def setenv(**kv):
        for k, v in kv.items():
            monkeypatch.setenv(k, v)
    return setenv


def _line(out: str, program: str) -> dict:
    """The program's result line as {key: value string}, in order, parsed
    as ``chip_smoke.py`` phase 14 (e) parses the pods' output."""
    return chip_smoke.train_program_line(out, program)


def _losses(line: dict) -> list:
    if "losses" in line:
        return ast.literal_eval(line["losses"])
    return [float(line["first_loss"]), float(line["last_loss"])]


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_program_prints_the_reference_line(program, pod, capsys):
    port, ref, knobs = PROGRAMS[program]
    pod(**knobs)
    assert ref.main() == 0
    want = _line(capsys.readouterr().out, program)
    assert port.main(device="cpu") == 0
    got = _line(capsys.readouterr().out, program)
    # phase 14 (e) holds the pods to these keys on the card
    assert list(got) == list(want) == list(
        chip_smoke.TRAIN_PROGRAM_KEYS[program])
    losses = _losses(got)
    assert all(np.isfinite(losses)), losses
    if program != "llama_pjit":
        # one fixed batch; llama_pjit draws a new one each step and, as
        # the reference, gates finiteness only
        assert losses[-1] < losses[0], losses
    if program == "llama_pjit":
        assert got["mesh"] == "{'dp': 1}" and got["devices"] == "1"
        assert got["workers"] == want["workers"] == "1"
        assert got["start_step"] == "0" and got["resumed_opt"] == "False"
    if program == "resnet_single":
        assert got["chips"] == want["chips"] == "[0]"


@pytest.mark.parametrize("preset", ["b16", "50"])
def test_full_width_presets_pick_the_reference_configs(preset, monkeypatch):
    """``VIT_PRESET=b16`` builds ViT-B/16 and ``RESNET_PRESET=50``
    ResNet-50 (100 classes); the programs are cut off at the config (no
    full-width step on the CPU)."""
    seen = {}

    class Stop(Exception):
        pass

    if preset == "b16":
        monkeypatch.setenv("VIT_PRESET", "b16")

        def fake_init(cfg, **kw):
            seen["cfg"] = cfg
            raise Stop
        monkeypatch.setattr("kubegpu_tpu_torch.models.vit.vit_init",
                            fake_init)
        with pytest.raises(Stop):
            vit_train.main(device="cpu")
        from kubegpu_tpu.models.vit import ViTConfig as JV
        ref = JV.base_16()
        assert (seen["cfg"].image_size, seen["cfg"].d_model,
                seen["cfg"].n_layers, seen["cfg"].n_heads, seen["cfg"].d_ff,
                seen["cfg"].dtype) == (ref.image_size, ref.d_model,
                                       ref.n_layers, ref.n_heads, ref.d_ff,
                                       ref.dtype)
    else:
        monkeypatch.setenv("RESNET_PRESET", "50")
        monkeypatch.delenv("KUBETPU_EXPECT_CHIPS", raising=False)

        def fake_resnet50(num_classes, **kw):
            seen["classes"] = num_classes
            raise Stop
        monkeypatch.setattr("kubegpu_tpu_torch.models.resnet.resnet50",
                            fake_resnet50)
        with pytest.raises(Stop):
            resnet_single.main(device="cpu")
        assert seen["classes"] == 100


def test_resnet_refuses_a_wrong_chip_count(pod, capsys):
    pod(KUBETPU_EXPECT_CHIPS="2", TPU_VISIBLE_CHIPS="0")
    assert resnet_single.main(device="cpu") == 2
    assert j_resnet.main() == 2
    err = capsys.readouterr().err
    assert err.count("FAIL: expected 2 chips, got [0]") == 2


@pytest.mark.parametrize("program", ["llama_pjit", "vit_train", "t5_train"])
def test_a_second_worker_raises(program, pod):
    pod(JAX_NUM_PROCESSES="2", TPU_WORKER_ID="1")
    with pytest.raises(NotImplementedError, match="2 workers"):
        PROGRAMS[program][0].main(device="cpu")


def test_t5_tensor_parallel_raises(pod):
    pod(T5_TP="2")
    with pytest.raises(NotImplementedError, match="item 9"):
        t5_train.main(device="cpu")


def test_llama_checkpoint_dir_raises(pod, tmp_path):
    pod(LLAMA_CKPT_DIR=str(tmp_path))
    with pytest.raises(NotImplementedError, match="TrainCheckpointer"):
        llama_pjit.main(device="cpu")


def test_llama_mesh_of_many_devices_raises(pod, monkeypatch):
    """A mesh that fits more than one device (here two cards seen) waits
    for item 9."""
    pod(LLAMA_MESH="dp:2", LLAMA_STEPS="1")
    monkeypatch.setattr(llama_pjit, "_n_devices", lambda device: 2)
    with pytest.raises(NotImplementedError, match="item 9"):
        llama_pjit.main(device="cpu")


def test_llama_profile_dir_writes_a_chrome_trace(pod, tmp_path, capsys):
    import json
    pod(LLAMA_PROFILE_DIR=str(tmp_path), LLAMA_STEPS="2")
    assert llama_pjit.main(device="cpu") == 0
    trace = json.loads((tmp_path / "llama_pjit.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train_step_0", "train_step_1"} <= names
    assert len(_losses(_line(capsys.readouterr().out, "llama_pjit"))) == 2


@pytest.mark.parametrize("spec,n", [
    (None, 1), (None, 8), ("dp:2,tp:2", 4), ("dp:2,tp:2", 1),
    ("dp:2,tp:2", 2), ("fsdp:4,tp:2", 4), ("dp:3", 2), ("tp:8", 8),
    ("dp:1,fsdp:2,tp:4", 2), ("dp:4, tp:2", 8)])
def test_parse_mesh_is_the_reference(spec, n, monkeypatch):
    monkeypatch.delenv("KUBETPU_MESH_AXES", raising=False)
    assert llama_pjit.parse_mesh(spec, n) == j_llama.parse_mesh(spec, n)


def test_parse_mesh_reads_the_injected_axes(monkeypatch):
    monkeypatch.setenv("KUBETPU_MESH_AXES", '[["dp", 2], ["tp", 4]]')
    for n in (8, 4, 1):
        assert llama_pjit.parse_mesh(None, n) == j_llama.parse_mesh(None, n)


def test_vit_images_are_jax_uniform_bit_for_bit(pod, monkeypatch):
    """The fixed batch the program trains on equals the reference's
    ``jax.random.uniform(PRNGKey(0), (8, 32, 32, 3))``."""
    from kubegpu_tpu_torch.models import vit as tv
    seen = {}
    real = tv.make_vit_train_step

    def recording(cfg, opt, mesh=None):
        step = real(cfg, opt, mesh)

        def wrapped(params, state, images, labels):
            seen.setdefault("images", images.clone())
            seen.setdefault("labels", labels.clone())
            return step(params, state, images, labels)
        return wrapped

    monkeypatch.setattr(tv, "make_vit_train_step", recording)
    pod(VIT_STEPS="1")
    assert vit_train.main(device="cpu") == 0
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                        (8, 32, 32, 3)))
    np.testing.assert_array_equal(seen["images"].numpy(), ref)
    np.testing.assert_array_equal(seen["labels"].numpy(), np.arange(8) % 10)


def test_programs_default_to_the_card(pod):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    for port, _, knobs in PROGRAMS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.main()
