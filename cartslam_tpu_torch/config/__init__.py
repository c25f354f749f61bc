from .registry import build_pipeline, create_data_source, read_config  # noqa: F401
