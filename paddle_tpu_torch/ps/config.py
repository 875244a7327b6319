"""PaddleRec-style YAML job config → framework objects.

The port's own copy of ``paddle_tpu.ps.config``. The reference's PS
jobs are configured through PaddleRec YAML files
(``hyper_parameters`` + ``runner`` blocks; e.g. the unittests/ps/
``*_ps_config.yaml`` family) that ``ps_dnn_trainer.py``'s
``get_user_defined_strategy`` turns into a ``DistributedStrategy`` and a
model; ``test_the_one_ps.py`` diff-tests that derivation WITHOUT running
a job. This module keeps that user surface: the same YAML schema loads
into (:class:`CtrConfig`, :class:`TableConfig`,
:class:`DistributedStrategy`, trainer selection), so a PaddleRec rank
job moves over by pointing at its existing config.

Mapping notes (documented divergences, not guesses):
- ``sparse_inputs_slots`` counts the label slot (PaddleRec convention) —
  the model gets N−1 sparse slots;
- ``sparse_feature_dim`` is the per-feature embedding vector the model
  consumes; in the CTR accessor layout that vector is
  ``embed_w ++ embedx`` → ``embedx_dim = sparse_feature_dim − 1``;
- ``sync_mode`` selects both the strategy flags (exactly the reference's
  get_user_defined_strategy branches) and the trainer: ``gpubox``/
  ``heter`` run the pass path (HBM cache, CtrPassTrainer role),
  ``sync``/``async``/``geo`` the stream path (CtrStreamTrainer).

In the port: a path source imports PyYAML at the call (a dict source
needs no YAML); ``make_model_config`` returns the port's ``CtrConfig``;
``make_optimizer`` builds any of the JAX package's dense optimizer
classes; and the SSD engine's scale knobs that the port's table does not bind
(``ssd_block_compress``, ``ssd_admission_threshold``,
``ssd_admission_sketch_kb``, ``ssd_bg_compact``, ``ssd_io_budget_mbps``)
raise when a config sets them off their defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

from ..core.enforce import InvalidArgumentError, UnavailableError, enforce
from ..distributed.strategy import DistributedStrategy
from .accessor import AccessorConfig, CtrCommonAccessor
from .accessor import accessor_class as _resolve
from .table import TableConfig

__all__ = ["PsJobConfig", "load_ps_config"]

_MODES = ("sync", "async", "geo", "heter", "gpubox")
# SSD engine knobs the port's TableConfig does not carry, with the JAX defaults
_UNBOUND_SSD_KNOBS = {"ssd_block_compress": False, "ssd_admission_threshold": 0,
                      "ssd_admission_sketch_kb": 64, "ssd_bg_compact": False,
                      "ssd_io_budget_mbps": 0.0}


@dataclasses.dataclass
class PsJobConfig:
    """Everything a PS job derives from one YAML file."""

    sync_mode: str
    thread_num: int
    num_sparse_slots: int
    sparse_feature_number: int
    dense_input_dim: int
    fc_sizes: Tuple[int, ...]
    optimizer_class: str
    learning_rate: float
    table: TableConfig
    strategy: Any          # DistributedStrategy
    trainer: str           # "CtrPassTrainer" | "CtrStreamTrainer"
    raw: Dict[str, Any]

    def make_model_config(self):
        from ..models.ctr import CtrConfig

        return CtrConfig(
            num_sparse_slots=self.num_sparse_slots,
            num_dense=self.dense_input_dim,
            embedx_dim=self.table.accessor_config.embedx_dim,
            dnn_hidden=self.fc_sizes,
        )

    def make_optimizer(self):
        from .. import optimizer as opt_mod

        # case-insensitive: PaddleRec configs commonly spell `class: adam`
        by_name = {n.lower(): getattr(opt_mod, n) for n in opt_mod.__all__
                   if isinstance(getattr(opt_mod, n, None), type)}
        cls = by_name.get(self.optimizer_class.lower())
        enforce(cls is not None,
                f"unknown optimizer class {self.optimizer_class!r}")
        return cls(learning_rate=self.learning_rate)


def _get(cfg: Dict[str, Any], dotted: str, default=None):
    cur: Any = cfg
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    # an explicit `key:` with no value parses as None — same as absent
    return default if cur is None else cur


def _hp(hp: Dict[str, Any], key: str, default):
    v = hp.get(key, default)
    return default if v is None else v


def load_ps_config(source: Union[str, Dict[str, Any]]) -> PsJobConfig:
    """Load a PaddleRec-style YAML file (path) or an equivalent dict."""
    if isinstance(source, str):
        import yaml

        with open(source) as f:
            cfg = yaml.safe_load(f)
    else:
        cfg = dict(source)
    # YAML spells an empty block as null — treat it like a missing one
    enforce(isinstance(cfg, dict)
            and isinstance(cfg.get("hyper_parameters"), dict),
            "config needs a non-empty hyper_parameters block")
    hp = cfg["hyper_parameters"]

    slots_with_label = int(_hp(hp, "sparse_inputs_slots", 27))
    feature_dim = int(_hp(hp, "sparse_feature_dim", 9))
    enforce(feature_dim >= 2, "sparse_feature_dim must be >= 2 "
            "(embed_w + at least one embedx column)")
    opt_cfg = _hp(hp, "optimizer", {})

    sync_mode = str(_get(cfg, "runner.sync_mode", "async")).lower()
    if sync_mode not in _MODES:
        raise InvalidArgumentError(
            f"runner.sync_mode must be one of {_MODES}, got {sync_mode!r}")

    # strategy flags: get_user_defined_strategy's branches
    strategy = DistributedStrategy()
    if sync_mode == "sync":
        strategy.a_sync = False
    elif sync_mode == "async":
        strategy.a_sync = True
    elif sync_mode == "geo":
        strategy.a_sync = True
        strategy.geo_sgd_mode = True
        strategy.geo_configs["geo_step"] = int(_get(cfg, "runner.geo_step",
                                                    100))
    elif sync_mode == "heter":
        strategy.a_sync = True
        strategy.a_sync_configs["heter_worker_device_guard"] = "tpu"
    elif sync_mode == "gpubox":
        strategy.a_sync = True
        strategy.a_sync_configs["use_ps_gpu"] = 1

    # accessor class is selectable the way TableAccessorParameter.
    # accessor_class is (the_one_ps.py:135-140 defaulting): either key
    # accepts the registry names (ctr / sparse / ctr_double / ... or the
    # reference class names CtrCommonAccessor / DownpourCtrDoubleAccessor)
    accessor_name = (_get(cfg, "table_parameters.accessor_class")
                     or _get(cfg, "runner.accessor_class") or "ctr")
    # fail fast at CONFIG time: unknown names raise, and non-feature
    # accessors (comm_merge/tensor — the Communicator/dense roles) are
    # rejected here rather than as an AttributeError deep inside table
    # construction or the first checkpoint save
    enforce(issubclass(_resolve(accessor_name), CtrCommonAccessor),
            f"accessor_class {accessor_name!r} is not a sparse feature "
            f"accessor (use ctr / sparse / ctr_double; comm_merge and "
            f"tensor are communicator/dense-table roles)")
    for knob, default in _UNBOUND_SSD_KNOBS.items():
        value = _get(cfg, f"table_parameters.{knob}", default)
        if type(default)(value) != default:
            raise UnavailableError(
                f"table_parameters.{knob}={value!r}: the SSD engine's scale knobs are not "
                "bound in the port yet (ROADMAP Queue A item 5)")
    table = TableConfig(
        shard_num=int(_get(cfg, "runner.thread_num", 16)),
        accessor=accessor_name,
        accessor_config=AccessorConfig(embedx_dim=feature_dim - 1),
        converter=_get(cfg, "table_parameters.converter"),
        # the storage/ssd_path pair itself is set by the server launcher
        ssd_value_dtype=str(_get(cfg, "table_parameters.ssd_value_dtype", "fp32")),
    )

    return PsJobConfig(
        sync_mode=sync_mode,
        thread_num=int(_get(cfg, "runner.thread_num", 16)),
        num_sparse_slots=slots_with_label - 1,
        sparse_feature_number=int(_hp(hp, "sparse_feature_number", 1 << 20)),
        dense_input_dim=int(_hp(hp, "dense_input_dim", 13)),
        fc_sizes=tuple(int(x) for x in _hp(hp, "fc_sizes",
                                           (400, 400, 400))),
        optimizer_class=str(opt_cfg.get("class") or "Adam"),
        learning_rate=float(opt_cfg.get("learning_rate") or 1e-3),
        table=table,
        strategy=strategy,
        trainer=("CtrPassTrainer" if sync_mode in ("gpubox", "heter")
                 else "CtrStreamTrainer"),
        raw=cfg,
    )
