"""Launch drivers of the port: the continuous-batching analytics service
(``service``), its serving smoke (``analytics``), the production-mesh
dry-run of the analytics step (``analytics_dryrun``, over ``mesh`` and
``dryrun``) and the LM serving driver (``serve``)."""
