"""REST service layer (reference: modules/siddhi-service)."""
from .rest import SiddhiService

__all__ = ["SiddhiService"]
