"""Host utilities of the port: the JAX package's ``utils``."""

from lmms_owc_tpu_torch.utils._caching import (
    delete_cache,
    load_from_cache,
    request_cache_dir,
    save_to_cache,
)
from lmms_owc_tpu_torch.utils._collation import DEFAULT_LENGTH_BUCKETS, Collator, pad_to_bucket
from lmms_owc_tpu_torch.utils._config import (
    apply_jinja_template,
    import_function,
    load_yaml_config,
    regex_replace,
)
from lmms_owc_tpu_torch.utils._core import (
    convert_non_serializable,
    create_iterator,
    foreach_chunk_pipelined,
    get_datetime_str,
    get_git_commit_hash,
    get_progress_bar,
    hash_string,
    json_dumps_deterministic,
    parse_string_args,
    pattern_match,
    positional_deprecated,
    sanitize_long_string,
    sanitize_model_name,
    sanitize_task_name,
    simple_parse_args_string,
)
from lmms_owc_tpu_torch.utils._data import (
    download_data,
    extract_data,
    load_image_folder_as_hf_dataset,
    write_jsonl,
)
from lmms_owc_tpu_torch.utils._logging import deprecated_positional, get_logger, rank_zero_only
from lmms_owc_tpu_torch.utils._tables import make_table

__all__ = [
    "Collator",
    "DEFAULT_LENGTH_BUCKETS",
    "apply_jinja_template",
    "convert_non_serializable",
    "create_iterator",
    "delete_cache",
    "download_data",
    "extract_data",
    "get_datetime_str",
    "get_git_commit_hash",
    "get_logger",
    "get_progress_bar",
    "hash_string",
    "import_function",
    "json_dumps_deterministic",
    "load_from_cache",
    "load_image_folder_as_hf_dataset",
    "load_yaml_config",
    "make_table",
    "pad_to_bucket",
    "parse_string_args",
    "pattern_match",
    "positional_deprecated",
    "deprecated_positional",
    "foreach_chunk_pipelined",
    "rank_zero_only",
    "regex_replace",
    "request_cache_dir",
    "sanitize_long_string",
    "sanitize_model_name",
    "sanitize_task_name",
    "save_to_cache",
    "simple_parse_args_string",
    "write_jsonl",
]
