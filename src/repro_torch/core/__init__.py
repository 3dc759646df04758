"""CB-SpMV core: the paper's contribution as a composable library."""
from .formats import (  # noqa: F401
    FMT_COO,
    FMT_CSR,
    FMT_DENSE,
    FormatThresholds,
    select_formats,
    should_column_aggregate,
    super_sparse_fraction,
)
from .blocking import BlockPartition, partition_coo  # noqa: F401
from .column_agg import ColumnAggregation, column_aggregate  # noqa: F401
from .aggregation import PackedBlocks, aggregate_blocks, pack_block, unpack_block  # noqa: F401
from .balance import BalanceResult, apply_balance, tb_load_balance  # noqa: F401
from .cb_matrix import CBMatrix  # noqa: F401
from .spmv_ref import dense_oracle, spmv_ref  # noqa: F401
