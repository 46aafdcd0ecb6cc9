"""TPC-DS connector of the PyTorch port: generator + SPI implementation."""
from .connector import TpcdsConnector

__all__ = ["TpcdsConnector"]
