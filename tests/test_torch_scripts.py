"""The port's twins of the JAX package's training scripts
(``scripts/port_instance_styleD_resnet101.sh`` and
``scripts/port_SGG_emb_resnet.sh``): every ``python`` line runs a module of
``i2vsgg_tpu_torch.tools`` with the flags of the matching line of the JAX
script, and the port's ``parse_args`` / ``set_dataset_args`` read them."""

import importlib
import os
import re
import shlex

import pytest

from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = {"port_instance_styleD_resnet101.sh": "instance_styleD_resnet101.sh",
         "port_SGG_emb_resnet.sh": "SGG_emb_resnet.sh"}


def python_lines(name):
    """Each ``python`` command of ``scripts/<name>``, continuation lines
    joined and the script's variables substituted (the positional ``$1``
    and values the shell computes, ``$(...)``, as 1), cut before its
    redirection or pipe."""
    text = open(os.path.join(ROOT, "scripts", name)).read()
    text = text.replace("\\\n", " ")
    env = {"1": "1"}
    commands = []
    for line in text.splitlines():
        line = re.split(r"\s#", line, 1)[0].strip()
        m = re.fullmatch(r"([A-Za-z_]\w*)=(\S.*)", line)
        if m:
            env[m.group(1)] = "1" if "$(" in m.group(2) else re.sub(
                r"\$\{?(\w+)\}?", lambda v: env[v.group(1)], m.group(2))
            continue
        if not line.startswith("python "):
            continue
        line = re.sub(r"\$\{?(\w+)\}?", lambda v: env[v.group(1)], line)
        tokens = shlex.split(line)
        for stop in ("2>&1", "|"):
            if stop in tokens:
                tokens = tokens[:tokens.index(stop)]
        commands.append(tokens)
    return commands


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twin_scripts_parse_with_the_port(twin):
    port, jax = python_lines(twin), python_lines(TWINS[twin])
    assert len(port) == len(jax) > 0
    for p, j in zip(port, jax):
        assert p[:2] == ["python", "-m"]
        module = p[2]
        assert module.startswith("i2vsgg_tpu_torch.tools.")
        tool = module.rsplit(".", 1)[1]
        assert j[1] == f"tools/{tool}.py"
        assert p[3:] == j[2:]                   # the same flags
        assert hasattr(importlib.import_module(module), "main")
        args = set_dataset_args(parse_args(p[3:]),
                                test=tool.startswith("test_"))
        assert args.device == "cuda" and args.net == "res101"
        assert args.dataset in ("MVRD", "MVidVRD")
