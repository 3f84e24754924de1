"""The port's deployment templates against the JAX package's.

Every template renders the JAX package's dict for the same overrides,
except that model nodes name ``CUDA_SERVER`` (C26) and the control-plane
config's shell line names the port's deployer CLI; every rendered
deployment passes the port's defaulting and validation.
"""

import json

import pytest

from seldon_core_tpu.controlplane import templates as jax_templates
from seldon_core_tpu_torch.controlplane import templates
from seldon_core_tpu_torch.controlplane.spec import DeploymentSpecError

OVERRIDES = {
    "single-model": [{}, {"softmax": "true", "replicas": "2", "input_shape": "[8]"}],
    "abtest": [{}, {"traffic_modela": "0.3"}],
    "mab": [{}, {"router": "thompson", "branches": "3"}],
    "od-model": [{}, {"detector": "isolation_forest", "threshold": "0.7"}],
    "od-transformer": [{}, {"detector": "vae", "n_features": "6"}],
    "proxy-model": [{}, {"dialect": "sagemaker"}, {"dialect": "rest", "path": "/v1/predict"}],
    "kafka-logging": [{}, {"topic": "pairs"}],
    "generation": [{}, {"speculative": "true", "draft_k": "6", "vocab_size": "16384", "max_len": "1024"}],
    "analytics": [{}, {"targets": '["a:1", "b:2"]'}],
    "loadtest": [{}, {"native": "true", "connections": "4"}],
    "controlplane": [{}, {"native_ingress": "true", "http_port": "9000"}],
}


def _jax_to_port(d):
    if isinstance(d, dict):
        return {k: ("CUDA_SERVER" if k == "implementation" and v == "JAX_SERVER" else _jax_to_port(v))
                for k, v in d.items()}
    if isinstance(d, list):
        return [_jax_to_port(v) for v in d]
    return d


def test_the_template_set_is_the_jax_packages():
    assert list(templates.TEMPLATES) == list(jax_templates.TEMPLATES) == list(OVERRIDES)
    for name, t in templates.TEMPLATES.items():
        j = jax_templates.TEMPLATES[name]
        assert (t.kind, t.reference_chart, t.description) == (j.kind, j.reference_chart, j.description)
        assert [(p.name, p.default, p.kind) for p in t.params] == [(p.name, p.default, p.kind) for p in j.params]


@pytest.mark.parametrize("name,overrides", [(n, o) for n, os_ in OVERRIDES.items() for o in os_],
                         ids=lambda v: v if isinstance(v, str) else json.dumps(v, sort_keys=True))
def test_renders_the_jax_packages_dict(name, overrides):
    mine, theirs = templates.render(name, overrides), jax_templates.render(name, overrides)
    expected = _jax_to_port(theirs)
    if name == "controlplane":
        assert theirs["equivalent_shell"].startswith("seldon-tpu-deploy run ")
        expected["equivalent_shell"] = theirs["equivalent_shell"].replace("seldon-tpu-deploy", "seldon-tpu-torch-deploy")
    assert mine == expected
    if "JAX_SERVER" in json.dumps(theirs):
        assert "JAX_SERVER" not in json.dumps(mine) and "CUDA_SERVER" in json.dumps(mine)


def test_errors_match():
    for bad in (("mab", {"router": "nope"}), ("abtest", {"traffic_modela": "2"}), ("single-model", {"x": 1}),
                ("od-model", {"detector": "nope"}), ("nope", {})):
        with pytest.raises(templates.TemplateError) as mine:
            templates.render(*bad)
        with pytest.raises(jax_templates.TemplateError) as theirs:
            jax_templates.render(*bad)
        assert str(mine.value) == str(theirs.value)


def test_cli_list_show_render(tmp_path, capsys):
    assert templates.main(["list"]) == 0
    assert "generation" in capsys.readouterr().out
    assert templates.main(["show", "mab"]) == 0
    assert "--set epsilon=<float>" in capsys.readouterr().out
    out = tmp_path / "dep.json"
    assert templates.main(["render", "single-model", "--json", "-o", str(out)]) == 0
    assert json.loads(out.read_text())["predictors"][0]["graph"]["implementation"] == "CUDA_SERVER"
    assert templates.main(["render", "single-model", "--set", "noequals"]) == 2
    assert templates.main(["render", "single-model", "--set", "num_classes=x"]) == 2


def test_rendered_deployments_validate_in_the_port():
    from seldon_core_tpu_torch.controlplane import TpuDeployment, default_and_validate

    for name, t in templates.TEMPLATES.items():
        if t.kind == "deployment":
            dep = default_and_validate(TpuDeployment.from_dict(templates.render(name)))
            assert dep.status["rewrites"] == []  # rendered specs already name CUDA_SERVER
    with pytest.raises(DeploymentSpecError):
        default_and_validate(TpuDeployment.from_dict({"name": "x", "predictors": []}))
