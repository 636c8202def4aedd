from siddhi_tpu_torch.service.rest import SiddhiRestService  # noqa: F401
