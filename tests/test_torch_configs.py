"""The port's ``config_from_yaml`` and its reader of the reference's YAML subset
(``foley_tpu_torch/utils/config_utils.py``), against the JAX package's ``config_from_yaml``
(which reads with ``yaml.safe_load``) and its presets."""

import dataclasses

import pytest
import yaml

import foley_tpu.configs as jconfigs
from foley_tpu.utils.config_utils import AttributeDict as JAttributeDict
from foley_tpu_torch.configs import YAML_DIR, config_from_yaml, get_config
from foley_tpu_torch.utils.config_utils import AttributeDict, load_yaml, parse_yaml

NAMES = ["xl", "xxl"]


def _path(name):
    return YAML_DIR / f"hunyuanvideo-foley-{name}.yaml"


@pytest.mark.parametrize("name", NAMES)
def test_yaml_copies_equal_the_jax_packages(name):
    jax_path = YAML_DIR.parents[2] / "foley_tpu" / "configs" / "yaml" / _path(name).name
    assert _path(name).read_bytes() == jax_path.read_bytes()


@pytest.mark.parametrize("name", NAMES)
def test_config_from_yaml_equals_jax(name):
    got = config_from_yaml(str(_path(name)))
    ref = jconfigs.config_from_yaml(str(_path(name)))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(jconfigs.get_config(name).model)
    assert got.model == get_config(name).model and got.diffusion == get_config(name).diffusion


@pytest.mark.parametrize("name", NAMES)
def test_reader_equals_safe_load(name):
    text = _path(name).read_text()
    assert parse_yaml(text) == yaml.safe_load(text)
    got, ref = load_yaml(str(_path(name))), JAttributeDict(yaml.safe_load(text))
    assert got.to_dict() == ref.to_dict()
    assert got.model_config.model_kwargs.hidden_size == ref.model_config.model_kwargs.hidden_size


SUBSET = """# a comment
top:
  int: 12
  neg: -3
  float: 4.0
  exp: 1.5e-06
  yes_bool: true
  no_bool: False
  nothing: null
  tilde: ~
  dq: "gelu_tanh # not a comment"
  sq: 'it''s'
  bare: HunyuanVideo-Foley-XXL  # a comment
  empty:
  nested:
    deeper:
      leaf: 1

other: bf16
"""


def test_reader_takes_its_subset_as_safe_load_does():
    assert parse_yaml(SUBSET) == yaml.safe_load(SUBSET)


@pytest.mark.parametrize("text,where", [
    ("a:\n  - 1\n  - 2\n", ":2"),              # a list
    ("a: [1, 2]\n", ":1"),                     # a flow sequence
    ("a: {b: 1}\n", ":1"),                     # a flow mapping
    ("a: &x 1\n", ":1"),                       # an anchor
    ("a: !!str 1\n", ":1"),                    # a tag
    ("a: |\n  text\n", ":1"),                  # a block scalar
    ("---\na: 1\n", ":1"),                     # a document marker
    ("a: 1\n\tb: 2\n", ":2"),                  # a tab
    ("a: 1\na: 2\n", ":2"),                    # a duplicate key
    ("a: yes\n", ":1"),                        # YAML 1.1 reads it as a bool
    ("a: 1e-5\n", ":1"),                       # YAML 1.1 reads it as a string
    ("a: 0x10\n", ":1"),                       # an int in hex
    ("a: 012\n", ":1"),                        # an int in octal
    ("a: .inf\n", ":1"),
    ("a:\n    b: 1\n  c: 2\n", ":3"),          # indentation matching no open mapping
    ("a: 'open\n", ":1"),                      # an unterminated quote
    ("1: x\n", ":1"),                          # a key YAML reads as an int
    ("a b\n", ":1"),                           # no colon
    ("a:b\n", ":1"),                           # no space after the colon
])
def test_reader_refuses_yaml_outside_its_subset_naming_the_line(text, where):
    with pytest.raises(ValueError, match=f"cfg.yaml{where}:"):
        parse_yaml(text, source="cfg.yaml")


def test_attribute_dict_matches_jax():
    data = {"model-config": {"hidden size": 3, "list": [{"a": 1}]}, "9lives": 1}
    got, ref = AttributeDict(data), JAttributeDict(data)
    assert got.model_config.hidden_size == ref.model_config.hidden_size == 3
    assert got._9lives == ref._9lives == 1
    assert got.model_config.list[0].a == 1
    assert got.get("missing", 5) == 5 and "9lives" in got and len(got) == 2
    assert got.to_dict() == ref.to_dict() == data
    with pytest.raises(AttributeError):
        got.missing
