from cloudberry_tpu_torch.catalog.catalog import Catalog, Table, DistributionPolicy

__all__ = ["Catalog", "Table", "DistributionPolicy"]
