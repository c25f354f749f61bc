from .registry import (  # noqa: F401
    build_pipeline,
    build_system,
    create_data_source,
    read_config,
    read_system_config,
)
