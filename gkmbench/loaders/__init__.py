"""Data loaders, one module a loader, found by the name a configuration's
file gives under ``loader``. Each has ``load(config, seed, here) ->
Data``: the same seed gives the same inputs."""
