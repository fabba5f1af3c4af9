"""Launch drivers of the port: the continuous-batching analytics service
(``service``) and its serving smoke (``analytics``)."""
