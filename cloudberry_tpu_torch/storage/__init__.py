from cloudberry_tpu_torch.storage.micropartition import (
    read_columns,
    read_footer,
    write_micropartition,
)
from cloudberry_tpu_torch.storage.table_store import TableStore

__all__ = ["write_micropartition", "read_footer", "read_columns", "TableStore"]
