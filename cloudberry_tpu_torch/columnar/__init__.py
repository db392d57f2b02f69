from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
from cloudberry_tpu_torch.columnar.batch import ColumnBatch

__all__ = ["StringDictionary", "ColumnBatch"]
