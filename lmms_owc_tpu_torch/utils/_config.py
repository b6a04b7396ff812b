"""YAML task-config loading with ``include:`` inheritance and ``!function`` tags,
plus jinja2 prompt templating (the JAX package's ``utils._config``).

``!function assets/_x_utils.fn`` imports the callable from a python file
resolved relative to the YAML's directory.
"""

from __future__ import annotations

import importlib.util
import sys
from functools import lru_cache
from pathlib import Path
from typing import Any, Callable

import yaml
from jinja2 import BaseLoader, Environment, StrictUndefined

__all__ = [
    "load_yaml_config",
    "import_function",
    "apply_jinja_template",
    "regex_replace",
]


@lru_cache(maxsize=None)
def _import_module_from_path(module_path: str) -> Any:
    path = Path(module_path)
    module_name = f"owc_torch_yamlfn_{abs(hash(module_path))}_{path.stem.lstrip('_')}"
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, module_path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import module from {module_path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def import_function(spec_string: str, yaml_path: str | Path | None) -> Callable:
    """Resolve a ``!function module.fn`` spec relative to the YAML file's directory."""
    module_part, _, fn_name = spec_string.rpartition(".")
    if not module_part:
        raise ValueError(f"invalid !function spec: {spec_string!r}")
    base = Path(yaml_path).parent if yaml_path is not None else Path.cwd()
    module_file = base / (module_part + ".py")
    if not module_file.exists():
        # Fall back to an importable dotted module on sys.path.
        import importlib

        module = importlib.import_module(module_part.replace("/", "."))
        return getattr(module, fn_name)
    module = _import_module_from_path(str(module_file.resolve()))
    return getattr(module, fn_name)


def _make_loader(yaml_path: str | Path | None, mode: str) -> type[yaml.SafeLoader]:
    class _Loader(yaml.SafeLoader):
        pass

    def _function_constructor(loader: yaml.SafeLoader, node: yaml.Node):
        spec_string = loader.construct_scalar(node)
        if mode == "simple":
            return spec_string
        return import_function(spec_string, yaml_path)

    _Loader.add_constructor("!function", _function_constructor)
    return _Loader


def load_yaml_config(
    yaml_path: str | Path | None = None,
    yaml_config: dict | None = None,
    yaml_dir: str | Path | None = None,
    mode: str = "full",
) -> dict:
    """Load a task YAML, resolving ``!function`` tags and recursive ``include:`` merges.

    ``include:`` may be a single path or list of paths relative to the YAML's
    directory; included configs are merged beneath the including config (the
    includer wins on key conflicts), matching reference semantics
    (src/utils/_data_utils.py:330-392).

    Args:
        yaml_path: path to the YAML file (used to resolve relative includes/functions).
        yaml_config: pre-parsed config (used when re-resolving includes from memory).
        yaml_dir: directory for resolving includes when ``yaml_path`` is absent.
        mode: "full" resolves !function into callables; "simple" leaves the spec string.
    """
    if yaml_config is None:
        if yaml_path is None:
            raise ValueError("either yaml_path or yaml_config is required")
        with open(yaml_path, encoding="utf-8") as f:
            yaml_config = yaml.load(f, Loader=_make_loader(yaml_path, mode))
    if yaml_config is None:
        yaml_config = {}
    if yaml_dir is None and yaml_path is not None:
        yaml_dir = Path(yaml_path).parent

    if "include" not in yaml_config:
        return yaml_config

    include = yaml_config.pop("include")
    if isinstance(include, str):
        include = [include]
    # Later includes take lower precedence; reference iterates reversed so the
    # first listed include wins among includes, and the including file wins overall.
    final: dict = {}
    for inc in reversed(include):
        inc_path = Path(inc)
        if not inc_path.is_absolute():
            if yaml_dir is None:
                raise ValueError(f"relative include {inc!r} with unknown base dir")
            inc_path = Path(yaml_dir) / inc_path
        included = load_yaml_config(yaml_path=inc_path, mode=mode)
        final.update(included)
    final.update(yaml_config)
    return final


def regex_replace(string: str, pattern: str, repl: str, count: int = 0) -> str:
    """Jinja filter: regex substitution."""
    import re

    return re.sub(pattern, repl, string, count=count)


_JINJA_ENV = Environment(loader=BaseLoader(), undefined=StrictUndefined, keep_trailing_newline=True)
_JINJA_ENV.filters["regex_replace"] = regex_replace


def apply_jinja_template(template: str, doc: dict) -> str:
    """Render a ``doc_to_*`` jinja template against a document dict."""
    return _JINJA_ENV.from_string(template).render(**doc)
