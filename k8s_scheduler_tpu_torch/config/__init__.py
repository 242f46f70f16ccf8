from .types import (  # noqa: F401
    PluginEntry,
    Plugins,
    PluginSet,
    Profile,
    SchedulerConfiguration,
    default_plugins,
)
