from .types import (  # noqa: F401
    Extender,
    PluginEntry,
    Plugins,
    PluginSet,
    Profile,
    SchedulerConfiguration,
    default_plugins,
    load_config,
)
