"""Model-parallel state: the process-group registry (counterpart of
:mod:`apex_tpu.transformer.parallel_state`).

Reference: ``apex/transformer/parallel_state.py`` — ``initialize_model_
parallel`` (:155) builds NCCL process groups for TP/PP/DP and ~50
getters expose their ranks, sizes and groups.  The JAX package turns the
groups into named axes of one device mesh; here they are
``torch.distributed`` process groups again, one per axis, built with
``torch.distributed.new_group`` over the default group that
:func:`apex_tpu_torch.parallel.multiproc.initialize_distributed` starts
(one process a rank: NCCL on CUDA, gloo on the CPU).

Every axis is ported: data, pipeline, context and tensor parallelism.
The ranks are laid out in the JAX mesh's ``AXIS_ORDER`` (dp, pp, cp,
tp) with tp innermost: rank = ((dp_rank * pp + pp_rank) * cp + cp_rank)
* tp + tp_rank, so a tensor-parallel group is a run of consecutive ranks
(one host's cards) and a rank's (dp, pp, cp, tp) coordinates are those
of the JAX mesh's device of the same index.  A pipeline group holds the
ranks of one (dp, cp, tp) triple, stage by stage; its first and last
ranks make the embedding group, its first the position-embedding group
(reference :339-372).  A context-parallel group holds the ranks of one
(dp, pp, tp) triple, chunk by chunk: the ring of
:mod:`apex_tpu_torch.transformer.context_parallel`.  A data-parallel
group holds those of one (pp, cp, tp) triple.  :class:`AxisGroup` is the
handle a getter returns: the axis name (it is a ``str``, as the JAX
package's handle is), its ``torch.distributed`` group (None for a
one-rank axis, over which no collective runs), its size, this process's
rank in it and the global ranks it holds.  Where the JAX package reads
a stage index off the mesh inside ``shard_map``, the port's getters
return this process's own.

A hierarchical data-parallel split (the ZeRO optimizers' ``dp_axes=
(outer, inner)`` or ``("dcn", outer, inner)``) is a set of nested groups
of each data-parallel group, one a hop
(:func:`get_data_parallel_hop_groups`): data-parallel rank ``d =
(i_slow * s_next + i_next) * ... + i_fast``, so the fast axis's ranks are
consecutive, as on the JAX package's ``(dp_out, dp_in)`` mesh.
``num_distributed_slices_`` (the JAX package's outer ``dcn`` axis) is
the size of a split's ``dcn`` hop: a split over more than one slice
must lead with that hop, and a ``dcn`` hop must span the slices.
"""

import dataclasses
from typing import Optional

# The JAX package's axis names (apex_tpu/transformer/parallel_state.py:32-52)
DATA_AXIS = "dp"
PIPELINE_AXIS = "pp"
CONTEXT_AXIS = "cp"
TENSOR_AXIS = "tp"
DCN_AXIS = "dcn"
DATA_OUTER_AXIS = "dp_out"
DATA_INNER_AXIS = "dp_in"
HIER_DP_AXES = (DCN_AXIS, DATA_OUTER_AXIS, DATA_INNER_AXIS)
AXIS_ORDER = (DATA_AXIS, PIPELINE_AXIS, CONTEXT_AXIS, TENSOR_AXIS)

__all__ = [
    "DATA_AXIS", "PIPELINE_AXIS", "CONTEXT_AXIS", "TENSOR_AXIS", "DCN_AXIS",
    "DATA_OUTER_AXIS", "DATA_INNER_AXIS", "HIER_DP_AXES", "AXIS_ORDER", "AxisGroup",
    "initialize_model_parallel", "model_parallel_is_initialized", "destroy_model_parallel",
    "get_tensor_model_parallel_world_size", "get_pipeline_model_parallel_world_size",
    "get_context_parallel_world_size", "get_data_parallel_world_size",
    "get_tensor_model_parallel_group", "get_pipeline_model_parallel_group",
    "get_context_parallel_group", "get_data_parallel_group", "get_model_parallel_group",
    "get_tensor_model_parallel_rank", "get_pipeline_model_parallel_rank",
    "get_context_parallel_rank", "get_data_parallel_rank", "get_data_parallel_src_rank",
    "get_tensor_model_parallel_src_rank", "get_num_distributed_slices",
    "get_data_parallel_hop_groups", "get_model_parallel_groups",
    "get_virtual_pipeline_model_parallel_world_size", "get_pipeline_model_parallel_split_rank",
    "get_virtual_pipeline_model_parallel_rank", "set_virtual_pipeline_model_parallel_rank",
    "get_pipeline_model_parallel_next_rank", "get_pipeline_model_parallel_prev_rank",
    "get_pipeline_model_parallel_first_rank", "get_pipeline_model_parallel_last_rank",
    "is_pipeline_first_stage", "is_pipeline_last_stage", "get_embedding_group",
    "get_position_embedding_group", "get_rank_info", "is_unitialized",
    "is_rank_in_embedding_group",
    "is_rank_in_position_embedding_group",
    "is_pipeline_stage_before_split", "is_pipeline_stage_after_split",
    "is_pipeline_stage_at_split", "is_rank_in_encoder_relative_position_embedding_group",
    "is_rank_in_decoder_relative_position_embedding_group",
    "get_encoder_relative_position_embedding_group",
    "get_decoder_relative_position_embedding_group", "set_pipeline_model_parallel_split_rank",
]


class AxisGroup(str):
    """A process-group handle: the axis name, with ``group`` (the
    ``torch.distributed`` ProcessGroup), ``size()``, ``rank()`` and
    ``ranks`` (the global ranks of the group, in its rank order)."""

    def __new__(cls, axis: str, group, size: int, rank: int, ranks=None):
        self = super().__new__(cls, axis)
        self.group = group
        self._size = int(size)
        self._rank = int(rank)
        self.ranks = tuple(ranks) if ranks is not None else None
        return self

    def size(self) -> int:
        return self._size

    def rank(self) -> int:
        return self._rank


@dataclasses.dataclass
class _State:
    data: AxisGroup
    tensor: AxisGroup
    pipeline: AxisGroup
    context: AxisGroup
    embedding: AxisGroup
    position_embedding: AxisGroup
    #: the encoder's and the decoder's stages of this rank's pipeline
    encoder_relative_position_embedding: AxisGroup
    decoder_relative_position_embedding: AxisGroup
    #: every pipeline group's global ranks (the split's groups cut each)
    pipes: tuple = ()
    virtual_pipeline_size: Optional[int] = None
    split_rank: Optional[int] = None
    #: every data-parallel group's global ranks, in the order they were
    #: built (the hop groups split each one, on every rank alike)
    data_groups: tuple = ()
    #: the outer ``dcn`` split of the data-parallel group
    num_distributed_slices: int = 1
    #: (axes, sizes) -> this rank's hop groups
    hop_groups: dict = dataclasses.field(default_factory=dict)
    # the model chunk being built or run (reference :679), set by the
    # interleaved schedule
    virtual_pipeline_rank: Optional[int] = None


_STATE: Optional[_State] = None


def initialize_model_parallel(
    tensor_model_parallel_size_: int = 1,
    pipeline_model_parallel_size_: int = 1,
    virtual_pipeline_model_parallel_size_: Optional[int] = None,
    pipeline_model_parallel_split_rank_: Optional[int] = None,
    context_parallel_size_: int = 1,
    num_distributed_slices_: int = 1,
) -> AxisGroup:
    """Build and register the process groups (reference
    ``parallel_state.initialize_model_parallel``, :155; the JAX
    package's :76 with its argument names).  Needs the default group
    (:func:`apex_tpu_torch.parallel.multiproc.initialize_distributed`);
    its world must divide by tp x pp x cp, as the JAX mesh's device count
    must, and the interleaved schedule needs pp of 2 or more (the JAX
    package's rule).  Every rank builds every group, in the same order
    (``torch.distributed.new_group``'s rule).  Returns this rank's
    data-parallel group."""
    import torch.distributed as dist

    global _STATE
    if not dist.is_initialized():
        raise RuntimeError("initialize_model_parallel needs the default process group: "
                           "call apex_tpu_torch.parallel.multiproc.initialize_distributed")
    world, rank = dist.get_world_size(), dist.get_rank()
    tp, pp = int(tensor_model_parallel_size_), int(pipeline_model_parallel_size_)
    cp = int(context_parallel_size_)
    if tp < 1 or pp < 1 or cp < 1 or world % (tp * pp * cp):
        raise RuntimeError(f"world size ({world}) is not divisible by tp ({tp}) x pp ({pp}) "
                           f"x cp ({cp})")
    if virtual_pipeline_model_parallel_size_ is not None and pp < 2:
        raise RuntimeError(
            "pipeline-model-parallel size should be greater than 2 with interleaved schedule")
    dp = world // (tp * pp * cp)
    slices = int(num_distributed_slices_)
    if slices < 1 or dp % slices:
        raise RuntimeError(f"data-parallel size ({dp}) not divisible by slices ({slices}): "
                           "model axes must fit inside one slice")

    def at(d, p, c, t):
        return ((d * pp + p) * cp + c) * tp + t

    def axis_group(axis, groups, real):
        """This rank's group among ``groups`` (lists of global ranks), each
        built on every rank; without ``real`` a one-rank group has none."""
        mine = None
        for ranks in groups:
            pg = dist.new_group(ranks) if real or len(ranks) > 1 else None
            if rank in ranks:
                mine = AxisGroup(axis, pg, len(ranks), ranks.index(rank), ranks)
        return mine

    data_groups = [[at(d, p, c, t) for d in range(dp)]
                   for p in range(pp) for c in range(cp) for t in range(tp)]
    data = axis_group(DATA_AXIS, data_groups, True)
    tensor = axis_group(TENSOR_AXIS, [[at(d, p, c, t) for t in range(tp)]
                                      for d in range(dp) for p in range(pp) for c in range(cp)],
                        False)
    pipes = [[at(d, p, c, t) for p in range(pp)]
             for d in range(dp) for c in range(cp) for t in range(tp)]
    pipeline = axis_group(PIPELINE_AXIS, pipes, False)
    context = axis_group(CONTEXT_AXIS, [[at(d, p, c, t) for c in range(cp)]
                                        for d in range(dp) for p in range(pp) for t in range(tp)],
                         False)
    split = pipeline_model_parallel_split_rank_
    _STATE = _State(data=data, tensor=tensor, pipeline=pipeline,
                    context=context, **_split_groups(pipes, pp, split),
                    pipes=tuple(tuple(r) for r in pipes),
                    virtual_pipeline_size=virtual_pipeline_model_parallel_size_,
                    split_rank=split, data_groups=tuple(tuple(r) for r in data_groups),
                    num_distributed_slices=slices)
    return data


def _split_groups(pipes, pp: int, split: Optional[int]) -> dict:
    """The groups the encoder/decoder split decides, cut from each
    pipeline (``pipes``, lists of global ranks) and built on every rank in
    the same order: its first and last ranks make the embedding group and
    its first the position-embedding group, each with the split stage
    (reference :339-372); its stages before the split the encoder's
    relative-position-embedding group and those from it on the decoder's
    (the JAX package's ``_relative_position_embedding_members``), both
    stage 0 alone without a split.  A group this rank is not in is
    :func:`_outside`."""
    import torch.distributed as dist

    rank = dist.get_rank()

    def group(members):
        """This rank's group among one per pipeline, each of ``members``
        (stage indices) of it."""
        mine = _outside()
        for r in pipes:
            ranks = [r[i] for i in members]
            pg = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = AxisGroup(PIPELINE_AXIS, pg, len(ranks), ranks.index(rank), ranks)
        return mine

    at_split = {split} if pp > 1 and split is not None else set()
    return {"embedding": group(sorted({0, pp - 1} | at_split)),
            "position_embedding": group(sorted({0} | at_split)),
            "encoder_relative_position_embedding": group(
                _relative_position_embedding_members(pp, split, True)),
            "decoder_relative_position_embedding": group(
                _relative_position_embedding_members(pp, split, False))}


def _relative_position_embedding_members(pp: int, split: Optional[int], encoder: bool) -> tuple:
    """The JAX package's :556: the encoder's stages, or the decoder's;
    stage 0 alone without a split (the reference's ``[ranks[0]]``)."""
    if pp == 1 or split is None:
        return (0,)
    return tuple(range(0, split)) if encoder else tuple(range(split, pp))


def _outside() -> AxisGroup:
    """The handle of a group this rank is not in (a middle stage's
    embedding group): no collective, size 0."""
    return AxisGroup(PIPELINE_AXIS, None, 0, -1, ())


def model_parallel_is_initialized() -> bool:
    """Reference: parallel_state.py:404."""
    return _STATE is not None


def _state() -> _State:
    if _STATE is None:
        raise RuntimeError("model parallel is not initialized (call initialize_model_parallel)")
    return _STATE


def destroy_model_parallel() -> None:
    """Reference: parallel_state.py:761.  The groups go with the default
    group (``multiproc.destroy_distributed``)."""
    global _STATE
    _STATE = None


# ------------------------------------------------------------------- sizes
def get_tensor_model_parallel_world_size() -> int:
    return _state().tensor.size()


def get_pipeline_model_parallel_world_size() -> int:
    return _state().pipeline.size()


def get_context_parallel_world_size() -> int:
    return _state().context.size()


def get_data_parallel_world_size() -> int:
    return _state().data.size()


def get_num_distributed_slices() -> int:
    """The outer ``dcn`` split of the data-parallel group (1: one slice)."""
    return _state().num_distributed_slices


# ------------------------------------------------------------------ groups
def get_tensor_model_parallel_group() -> AxisGroup:
    return _state().tensor


def get_pipeline_model_parallel_group() -> AxisGroup:
    return _state().pipeline


def get_context_parallel_group() -> AxisGroup:
    return _state().context


def get_data_parallel_group() -> AxisGroup:
    """Reference :462 (the JAX package's :259): this rank's data-parallel
    group, the ranks that hold its tensor-parallel rank."""
    return _state().data


def get_model_parallel_group() -> tuple:
    """The (pp, tp) groups a found-inf vote is agreed over, one after the
    other (the JAX package's combined (pp, tp) axes)."""
    s = _state()
    return (s.pipeline, s.tensor)


def get_model_parallel_groups(axes) -> tuple:
    """The groups of the model axes ``axes`` (names among ``"pp"`` and
    ``"tp"``), in that order: what a ZeRO optimizer gathers its model
    segments over."""
    s = _state()
    by_axis = {PIPELINE_AXIS: s.pipeline, TENSOR_AXIS: s.tensor}
    unknown = [a for a in axes if a not in by_axis]
    if unknown:
        raise ValueError(f"model axes {unknown} have no process group here (the port's model "
                         f"axes are {sorted(by_axis)})")
    return tuple(by_axis[a] for a in axes)


def get_data_parallel_hop_groups(axes, sizes) -> tuple:
    """This rank's hop groups of a hierarchical split of its
    data-parallel group: ``axes`` / ``sizes`` ordered slow to fast, their
    product the data-parallel size.  Data-parallel rank ``d`` has index
    ``i_j`` on hop ``j`` with ``d`` = Horner's rule over the indices,
    slow to fast (the fast ranks consecutive); hop ``j``'s group holds
    the ranks whose other indices are this rank's.  Built on first use,
    on every rank in the same order (``torch.distributed.new_group``'s
    rule), and cached.  The slowest hop is ``"dcn"``, of the slice
    count's size, exactly when ``num_distributed_slices_`` is above 1
    or the split names a ``"dcn"`` hop."""
    import itertools

    import torch.distributed as dist

    s = _state()
    axes, sizes = tuple(axes), tuple(int(n) for n in sizes)
    key = (axes, sizes)
    if key in s.hop_groups:
        return s.hop_groups[key]
    slices = s.num_distributed_slices
    if (slices > 1 or DCN_AXIS in axes) and (axes[0] != DCN_AXIS or sizes[0] != slices):
        raise ValueError(f"the split {dict(zip(axes, sizes))} does not lead with a "
                         f"{DCN_AXIS!r} hop over the {slices} slice(s) of "
                         "initialize_model_parallel(num_distributed_slices_=)")
    world = 1
    for n in sizes:
        world *= n
    if world != s.data.size():
        raise ValueError(f"the split {dict(zip(axes, sizes))} covers {world} ranks; the "
                         f"data-parallel group has {s.data.size()}")
    me = dist.get_rank()
    mine = [None] * len(axes)
    for ranks in s.data_groups:
        for j, axis in enumerate(axes):
            others = [range(n) for i, n in enumerate(sizes) if i != j]
            for rest in itertools.product(*others):
                members = []
                for i_j in range(sizes[j]):
                    idx = list(rest)
                    idx.insert(j, i_j)
                    d = 0
                    for i, n in zip(idx, sizes):
                        d = d * n + i
                    members.append(ranks[d])
                pg = dist.new_group(members)
                if me in members:
                    mine[j] = AxisGroup(axis, pg, len(members), members.index(me), members)
    s.hop_groups[key] = tuple(mine)
    return s.hop_groups[key]


# ------------------------------------------------------------------- ranks
def get_tensor_model_parallel_rank() -> int:
    return _state().tensor.rank()


def get_pipeline_model_parallel_rank() -> int:
    return _state().pipeline.rank()


def get_context_parallel_rank() -> int:
    return _state().context.rank()


def get_data_parallel_rank() -> int:
    """Reference :382 — this process's rank in the data-parallel group
    (the JAX package's traced ``axis_index``)."""
    return _state().data.rank()


def get_data_parallel_src_rank() -> int:
    """Reference :520: the global rank of this data-parallel group's
    rank 0 (this rank's tensor-parallel rank)."""
    return _state().data.ranks[0]


def get_embedding_group() -> AxisGroup:
    """Reference :471: the first and last stages of this rank's pipeline
    (the tied embedding), plus the split stage under an encoder/decoder
    split.  A middle stage is in none: size 0."""
    return _state().embedding


def get_position_embedding_group() -> AxisGroup:
    """Reference :480: the first stage of this rank's pipeline (plus the
    split stage)."""
    return _state().position_embedding


def get_tensor_model_parallel_src_rank() -> int:
    """Reference :512: the global rank of this tensor-parallel group's
    rank 0, the source of :func:`~apex_tpu_torch.transformer.
    tensor_parallel.broadcast_data`."""
    return _state().tensor.ranks[0]


def get_pipeline_model_parallel_next_rank() -> int:
    """Reference :730: the global rank of the next stage of this rank's
    pipeline (a ring: the last stage's next is the first)."""
    p = _state().pipeline
    return p.ranks[(p.rank() + 1) % p.size()]


def get_pipeline_model_parallel_prev_rank() -> int:
    """Reference :739: the global rank of the previous stage (a ring)."""
    p = _state().pipeline
    return p.ranks[(p.rank() - 1) % p.size()]


def get_pipeline_model_parallel_first_rank() -> int:
    """Reference :711: the global rank of this pipeline's first stage."""
    return _state().pipeline.ranks[0]


def get_pipeline_model_parallel_last_rank() -> int:
    """Reference :718: the global rank of this pipeline's last stage."""
    return _state().pipeline.ranks[-1]


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _state().virtual_pipeline_size


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _state().split_rank


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    """Reference :679: the model chunk being run."""
    return _state().virtual_pipeline_rank


def set_virtual_pipeline_model_parallel_rank(rank: Optional[int]) -> None:
    _state().virtual_pipeline_rank = rank


def is_pipeline_first_stage(ignore_virtual: bool = False, stage: Optional[int] = None) -> bool:
    """Reference :508: this rank (or ``stage``, a pp index) is the first
    stage and, unless ``ignore_virtual``, runs the first model chunk."""
    s = _state()
    if not ignore_virtual and s.virtual_pipeline_size is not None and \
            s.virtual_pipeline_rank not in (None, 0):
        return False
    return (s.pipeline.rank() if stage is None else stage) == 0


def is_pipeline_last_stage(ignore_virtual: bool = False, stage: Optional[int] = None) -> bool:
    """Reference :522: this rank (or ``stage``) is the last stage and,
    unless ``ignore_virtual``, runs the last model chunk."""
    s = _state()
    if not ignore_virtual and s.virtual_pipeline_size is not None and \
            s.virtual_pipeline_rank not in (None, s.virtual_pipeline_size - 1):
        return False
    return (s.pipeline.rank() if stage is None else stage) == s.pipeline.size() - 1


def is_rank_in_embedding_group(ignore_virtual: bool = False) -> bool:
    """Reference :504-517: this rank takes part in the tied embedding's
    grad sync -- it is in the embedding group and, unless
    ``ignore_virtual``, runs the first chunk on the first stage or the
    last chunk on the last."""
    s = _state()
    if s.embedding.size() == 0:
        return False
    if ignore_virtual:
        return True
    me, ranks = s.pipeline.ranks[s.pipeline.rank()], s.embedding.ranks
    if me == ranks[0]:
        return is_pipeline_first_stage()
    if me == ranks[-1]:
        return is_pipeline_last_stage()
    return True  # the split stage (reference :515-516: plain membership)


def is_rank_in_position_embedding_group() -> bool:
    """Reference :520: this rank holds the position embeddings (the first
    stage, plus the split stage)."""
    return _state().position_embedding.size() > 0


def get_rank_info() -> str:
    """Reference :421: the sizes, as the JAX package's debug string."""
    if _STATE is None:
        return "model parallel not initialized"
    s = _STATE
    return (f"tp={s.tensor.size()} pp={s.pipeline.size()} cp={s.context.size()} "
            f"dp={s.data.size()}")


def is_unitialized() -> bool:
    """Reference :79 (its spelling): no model-parallel state is registered."""
    return _STATE is None


# ------------------------------------------------- encoder/decoder split
# (T5-style models: stages [0, split) run the encoder, [split, pp) the
#  decoder; reference parallel_state.py:538-575, the JAX package's
#  :455-497 with its signatures: the stage index as the positional
#  ``rank`` or ``stage=``.)
def is_pipeline_stage_before_split(rank: Optional[int] = None, *,
                                   stage: Optional[int] = None) -> bool:
    """True if pipeline stage ``stage`` runs the encoder of a model with an
    encoder and a decoder (reference :538)."""
    s = _state()
    stage = rank if stage is None else stage
    if s.pipeline.size() == 1:
        return True
    if stage is None:
        raise ValueError("pass the static pipeline stage index")
    if s.split_rank is None:
        return True
    return stage < s.split_rank


def is_pipeline_stage_after_split(rank: Optional[int] = None, *,
                                  stage: Optional[int] = None) -> bool:
    """True if stage ``stage`` runs the decoder (reference :553)."""
    s = _state()
    stage = rank if stage is None else stage
    if s.pipeline.size() == 1:
        return True
    if stage is None:
        raise ValueError("pass the static pipeline stage index")
    if s.split_rank is None:
        return True
    return stage >= s.split_rank


def is_pipeline_stage_at_split(rank: Optional[int] = None, *,
                               stage: Optional[int] = None) -> bool:
    """True if stage ``stage`` is the last encoder stage, the next one the
    first decoder stage (reference :568-575)."""
    s = _state()
    stage = rank if stage is None else stage
    if s.pipeline.size() == 1 or s.split_rank is None:
        return False
    if stage is None:
        raise ValueError("pass the static pipeline stage index")
    return is_pipeline_stage_before_split(stage) and is_pipeline_stage_after_split(stage + 1)


def is_rank_in_encoder_relative_position_embedding_group(*,
                                                         stage: Optional[int] = None) -> bool:
    """Reference :526: stage ``stage`` is one of the encoder's, which share
    the encoder's relative-position-embedding grads."""
    if stage is None:
        raise ValueError("pass stage= (static pipeline stage index)")
    s = _state()
    return stage in _relative_position_embedding_members(s.pipeline.size(), s.split_rank, True)


def is_rank_in_decoder_relative_position_embedding_group(*,
                                                         stage: Optional[int] = None) -> bool:
    """Reference :532: stage ``stage`` is one of the decoder's."""
    if stage is None:
        raise ValueError("pass stage= (static pipeline stage index)")
    s = _state()
    return stage in _relative_position_embedding_members(s.pipeline.size(), s.split_rank, False)


def get_encoder_relative_position_embedding_group() -> AxisGroup:
    """The encoder stages of this rank's pipeline (stage 0 without a
    split); a rank outside it gets a group of size 0."""
    return _state().encoder_relative_position_embedding


def get_decoder_relative_position_embedding_group() -> AxisGroup:
    """The decoder stages of this rank's pipeline (stage 0 without a
    split); a rank outside it gets a group of size 0."""
    return _state().decoder_relative_position_embedding


def set_pipeline_model_parallel_split_rank(rank: Optional[int]) -> None:
    """Reference :614: set the split rank, and rebuild the groups it
    decides (:func:`_split_groups`: a collective, every rank calls it)."""
    s = _state()
    s.split_rank = rank
    for k, v in _split_groups(s.pipes, s.pipeline.size(), rank).items():
        setattr(s, k, v)
