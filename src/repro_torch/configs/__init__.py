"""Architecture configs of the port.

For now this holds ``grafs_analytics`` alone, the paper's own analytics
workload, which ``launch.analytics_dryrun`` runs at production scale.  The
reference's registry (``ARCHS``, the shape sets, ``get``, ``skip_reason``)
imports every model config, and those import the models, so the registry
and the model configs come with the port of the ML stack (ROADMAP Queue 1,
item 12c).
"""
