"""Control-flow macro ops: while / cond over sub-blocks + recurrent.

Port of `paddle_tpu/ops/control_flow_ops.py`, all 11 registrations.
Reference: paddle/fluid/operators/controlflow/while_op.cc (runs a sub-block
with a nested Executor per iteration, WhileGradOp for the backward pass),
conditional_block_op.cc, and recurrent_op.cc (static RNN with step scopes).
The JAX package traces the sub-block into lax.while_loop / lax.cond /
lax.scan bodies; the port's executor runs op by op, so each macro is the
reference's own shape again, a Python loop or branch over the sub-block's
ops:

  * while       — reads its condition once per iteration (one host read);
  * conditional_block — reads its predicate and runs only the taken branch;
  * recurrent   — a Python loop over the time axis, with the `lengths`
                  masking (memories freeze, outputs are zero once
                  t >= length).

Carried state = every var written in the sub-block that was defined outside
it (the same liveness rule the reference's while_op uses to decide what
persists across step scopes).

Gradients: each macro grad op replays its sub-block from the values the
forward stashed at the macro's entry and takes `torch.func.vjp` of the
replay (JAX: `jax.vjp`, `_vjp_into_env`). while_grad replays JAX's bounded
form: at most `max_trip_count` iterations, the carry frozen from the first
false condition on, so its gradients are JAX's even where the forward ran
longer. The grad makers are JAX's, so the same programs raise.

RNG: the forward's sub-block ops draw from the run's generator; the macro
stashes that generator's state at its entry (`@while@...`/`@cond@...`/
`@rnn@...` entries of the environment), and the replay draws from a new
generator set to it: the same dropout masks in the same order, and the
run's generator does not advance for the replay.
"""

import torch

from ..framework.core import GRAD_SUFFIX
from ..framework.registry import (LowerContext, lower_op,
                                  register_macro_op)


def _carry_names(sub_block, env):
    """Vars written in the sub-block that already exist in the outer env."""
    written = []
    seen = set()
    for op in sub_block.ops:
        for n in op.output_names():
            if n in env and n not in seen:
                seen.add(n)
                written.append(n)
    return written


def _block_outer_reads(program, sub_block):
    """Names read (transitively, through nested macro sub-blocks) by the
    sub-block's ops that resolve OUTSIDE the sub-block — the loop/branch
    closure. Deterministic build-time analog of the reference while_op's
    X input list."""
    reads = []
    seen = set()

    def walk(block):
        for op in block.ops:
            for n in op.input_names():
                if n and n not in block.vars and n not in seen:
                    seen.add(n)
                    reads.append(n)
            for key in ("sub_block", "sub_block_t", "sub_block_f"):
                if key in op.attrs:
                    walk(program.blocks[op.attrs[key]])

    walk(sub_block)
    return [n for n in reads if n not in sub_block.vars]


def _run_block(sub_block, env, ctx):
    for op in sub_block.ops:
        lower_op(ctx, op, env)


def _sub_ctx(ctx, rng_state=None, differentiable=None):
    """A context for a sub-block's ops. Without `rng_state` it shares the
    run's generator (the forward); with it, a new generator set to that
    state (a grad replay)."""
    c = LowerContext(device=ctx.device, abstract=ctx.abstract,
                     differentiable=(ctx.differentiable
                                     if differentiable is None
                                     else differentiable))
    if rng_state is None:
        c._gen = ctx.rng()
    else:
        c._gen = torch.Generator(device=ctx.device)
        c._gen.set_state(rng_state)
    return c


def _rng_state(ctx):
    return ctx.rng().get_state()


def _is_inexact(v):
    return isinstance(v, torch.Tensor) and (v.is_floating_point()
                                            or v.is_complex())


def _truth(v) -> bool:
    """A scalar predicate's value on the host (one read)."""
    return bool(v.reshape(()).item())


def _macro_diff_inputs(op, block, no_grad_set, names):
    """Filter closure/carry names down to those that want float grads."""
    from ..framework.backward import _var_wants_grad
    out = []
    for n in names:
        if n in out or not _var_wants_grad(block, n, no_grad_set):
            continue
        if block.has_var(n) and str(block.var(n).dtype).startswith("float"):
            out.append(n)
    return out


def _vjp_into_env(op, env, f, primals, out_pairs):
    """Common tail of every macro grad op: torch.func.vjp(f, *primals),
    seeded with the out-grads from env (zeros where the desc carries ""),
    then the input grads written into env under the op's X@GRAD names.

    out_pairs: [grad_var_name_or_empty, ...] aligned with f's outputs."""
    primals_out, vjp_fn = torch.func.vjp(f, *primals)
    cots = []
    for gname, primal in zip(out_pairs, primals_out):
        if gname and gname in env:
            cots.append(env[gname].to(primal.dtype))
        else:
            cots.append(torch.zeros_like(primal))
    grads = vjp_fn(tuple(cots))
    gnames = op.output("X" + GRAD_SUFFIX)
    for n, g in zip(gnames, grads):
        if n:
            env[n] = g


# ---------------------------------------------------------------------------
# while
# ---------------------------------------------------------------------------

def _while_grad_maker(op, block, no_grad_set):
    program = block.program
    sub = program.blocks[op.attrs["sub_block"]]
    carry = list(op.output("Out"))
    cond_name = op.input("Condition")[0]
    if cond_name not in carry:
        carry.append(cond_name)
    closure = _block_outer_reads(program, sub)
    diff = _macro_diff_inputs(op, block, no_grad_set,
                              closure + carry)
    if not diff:
        # nothing differentiable feeds the loop: every float it touches is
        # stop_gradient, so no stale contributions can exist either
        return []
    if "max_trip_count" not in op.attrs:
        raise RuntimeError(
            "cannot differentiate a While loop without a static trip bound "
            "(its gradient replays the loop in a bounded form); pass "
            f"max_trip_count=N to layers.While / layers.while_loop, or mark "
            f"the loop's float inputs/carries ({diff}) stop_gradient=True")
    return [{
        "type": "while_grad",
        "inputs": {"X": diff,
                   "Out" + GRAD_SUFFIX: [n + GRAD_SUFFIX
                                         for n in op.output("Out")]},
        "outputs": {"X" + GRAD_SUFFIX: [n + GRAD_SUFFIX for n in diff]},
        "attrs": {"sub_block": op.attrs["sub_block"],
                  "max_trip_count": int(op.attrs["max_trip_count"]),
                  "carry_hint": list(op.output("Out")),
                  "cond_name": cond_name},
        # the grads this op emits for carried vars are w.r.t. the value at
        # loop ENTRY; the downstream (post-loop) contributions were fully
        # consumed as cotangents here
        "reset_grads": [n for n in carry],
    }]


def _run_while(ctx, sub, outer, carry, cond_name, trip_bound):
    """Run the loop over `outer` bindings; returns the final carry dict.

    trip_bound=None loops while the condition holds. trip_bound=T is
    JAX's bounded masked scan: at most T iterations, the carry (the
    condition included) frozen from the first false condition on; the
    port stops there, which leaves the same values and gradients. Each
    iteration reads the condition once on the host."""
    cur = {n: outer[n] for n in carry}
    t = 0
    while (trip_bound is None or t < trip_bound) and _truth(cur[cond_name]):
        benv = dict(outer)
        benv.update(cur)
        _run_block(sub, benv, ctx)
        cur = {n: benv[n] for n in carry}
        t += 1
    return cur


@register_macro_op("while", grad_maker=_while_grad_maker)
def _while(ctx, op, env):
    program = op.block.program
    sub = program.blocks[op.attrs["sub_block"]]
    cond_name = op.input("Condition")[0]
    carry = _carry_names(sub, env)
    if cond_name not in carry:
        carry = carry + [cond_name]

    # stash loop-entry state for the grad replay (while overwrites its
    # carries in env, so the post-loop values are useless for AD)
    tag = f"@while@{sub.idx}@"
    env[tag + "rng"] = _rng_state(ctx)
    for n in carry:
        env[tag + "in@" + n] = env[n]

    trip_bound = None
    if ctx.differentiable:
        # inside an enclosing grad replay: lower the bounded form, as JAX
        # must (lax.while_loop is not reverse-differentiable)
        if "max_trip_count" not in op.attrs:
            raise RuntimeError(
                "a While loop without max_trip_count is nested inside a "
                "differentiated control-flow construct; pass "
                "max_trip_count=N so its gradient can be computed")
        trip_bound = int(op.attrs["max_trip_count"])

    final = _run_while(_sub_ctx(ctx), sub, env, carry, cond_name,
                       trip_bound)
    for n in carry:
        env[n] = final[n]


@register_macro_op("while_grad")
def _while_grad(ctx, op, env):
    program = op.block.program
    sub = program.blocks[op.attrs["sub_block"]]
    T = int(op.attrs["max_trip_count"])
    cond_name = op.attrs["cond_name"]
    tag = f"@while@{sub.idx}@"

    # same carry computation as the forward (env membership for these
    # names is unchanged by appended grad vars)
    carry = _carry_names(sub, env)
    if cond_name not in carry:
        carry = carry + [cond_name]
    entry = {n: env[tag + "in@" + n] for n in carry}

    diff = op.input("X")
    primals = [entry[n] if n in entry else env[n] for n in diff]

    # name -> grad-var for the forward's declared outputs
    out_names = op.attrs["carry_hint"]
    gmap = dict(zip(out_names, op.input("Out" + GRAD_SUFFIX)))
    rng = env[tag + "rng"]

    def f(*vals):
        outer = dict(env)
        outer.update(entry)
        outer.update(dict(zip(diff, vals)))
        gctx = _sub_ctx(ctx, rng, differentiable=True)
        fin = _run_while(gctx, sub, outer, carry, cond_name, T)
        return tuple(fin[n] for n in carry if _is_inexact(entry[n]))

    out_pairs = [gmap.get(n, "") for n in carry if _is_inexact(entry[n])]
    _vjp_into_env(op, env, f, primals, out_pairs)


# ---------------------------------------------------------------------------
# cond_block
# ---------------------------------------------------------------------------

def _cond_grad_maker(op, block, no_grad_set):
    program = block.program
    tb = program.blocks[op.attrs["sub_block_t"]]
    fb = program.blocks[op.attrs["sub_block_f"]]
    closure = _block_outer_reads(program, tb) + \
        _block_outer_reads(program, fb)
    # branch RETURN names that resolve outside their block are reads too:
    # a Switch pass-through branch has no ops at all, it just returns the
    # outer var — missing it here would leave the stale downstream grad
    # flowing around this op as if it did not exist
    for rets, blk in ((op.attrs["true_rets"], tb),
                      (op.attrs["false_rets"], fb)):
        closure += [n for n in rets if n not in blk.vars]
    closure += list(op.input("X"))
    diff = _macro_diff_inputs(op, block, no_grad_set, closure)
    if not diff:
        return []
    return [{
        "type": "conditional_block_grad",
        "inputs": {"X": diff,
                   "Out" + GRAD_SUFFIX: [n + GRAD_SUFFIX
                                         for n in op.output("Out")]},
        "outputs": {"X" + GRAD_SUFFIX: [n + GRAD_SUFFIX for n in diff]},
        "attrs": {k: op.attrs[k] for k in
                  ("sub_block_t", "sub_block_f", "true_rets", "false_rets")}
        | {"cond_var": op.input("Cond")[0],
           "out_hint": list(op.output("Out"))},
        "reset_grads": list(op.output("Out")),
    }]


def _run_branch(block, rets, outer, ctx):
    benv = dict(outer)
    _run_block(block, benv, ctx)
    return [benv[r] for r in rets]


@register_macro_op("conditional_block", grad_maker=_cond_grad_maker,
                   aliases=("cond_block", "conditional_block_infer"))
def _cond_block(ctx, op, env):
    """Two-branch conditional: attrs sub_block_t / sub_block_f; outputs Out
    are filled from attr-listed branch result names (true_rets/false_rets).
    Only the taken branch runs."""
    program = op.block.program
    tb = program.blocks[op.attrs["sub_block_t"]]
    fb = program.blocks[op.attrs["sub_block_f"]]
    out_names = op.output("Out")

    # stash branch-entry state: outputs may overwrite outer vars the
    # untaken branch passes through (Switch), so the grad replay needs
    # the pre-op values
    tag = f"@cond@{tb.idx}@"
    env[tag + "rng"] = _rng_state(ctx)
    for n in set(_block_outer_reads(program, tb)
                 + _block_outer_reads(program, fb) + list(out_names)
                 + list(op.input("Cond"))):
        if n in env:
            env[tag + "in@" + n] = env[n]

    if _truth(env[op.input("Cond")[0]]):
        outs = _run_branch(tb, op.attrs["true_rets"], env, _sub_ctx(ctx))
    else:
        outs = _run_branch(fb, op.attrs["false_rets"], env, _sub_ctx(ctx))
    for n, v in zip(out_names, outs):
        env[n] = v


@register_macro_op("conditional_block_grad", aliases=("cond_block_grad",))
def _cond_block_grad(ctx, op, env):
    program = op.block.program
    tb = program.blocks[op.attrs["sub_block_t"]]
    fb = program.blocks[op.attrs["sub_block_f"]]
    out_names = op.attrs["out_hint"]
    tag = f"@cond@{tb.idx}@"

    def entry(n):
        return env.get(tag + "in@" + n, env.get(n))

    taken = _truth(entry(op.attrs["cond_var"]))
    block, rets = ((tb, op.attrs["true_rets"]) if taken
                   else (fb, op.attrs["false_rets"]))
    diff = op.input("X")
    primals = [entry(n) for n in diff]
    gnames = op.input("Out" + GRAD_SUFFIX)
    rng = env[tag + "rng"]

    def f(*vals):
        outer = dict(env)
        for n in list(out_names) + list(diff):
            if tag + "in@" + n in env:
                outer[n] = env[tag + "in@" + n]
        outer.update(dict(zip(diff, vals)))
        outs = _run_branch(block, rets, outer,
                           _sub_ctx(ctx, rng, differentiable=True))
        return tuple(o for o in outs if _is_inexact(o))

    # align cotangent names with the float outputs f returns
    kept = []
    for n, g in zip(out_names, gnames):
        v = env.get(n)
        if v is None or _is_inexact(v):
            kept.append(g)
    _vjp_into_env(op, env, f, primals, kept)


# ---------------------------------------------------------------------------
# recurrent (StaticRNN / DynamicRNN): a time-major loop over a sub-block
# ---------------------------------------------------------------------------
#
# attrs:
#   sub_block     step body
#   step_inputs   [[outer_seq_name, inner_step_name], ...]  (outer: [T,...])
#   memories      [[boot_name, pre_name, post_name], ...]
#   step_outputs  [[inner_name, outer_stacked_name], ...]   (outer: [T,...])
#   lengths       optional name of a [B] int32 lengths var (DynamicRNN):
#                 memories freeze and outputs zero once t >= length
#
# Reference: operators/recurrent_op.cc (step-scope interpreter loop);
# layers/control_flow.py:294 StaticRNN, :1714 DynamicRNN.

def _recurrent_grad_maker(op, block, no_grad_set):
    program = block.program
    sub = program.blocks[op.attrs["sub_block"]]
    seq_outers = [o for o, _ in op.attrs["step_inputs"]]
    boots = [b for b, _, _ in op.attrs["memories"]]
    closure = _block_outer_reads(program, sub)
    diff = _macro_diff_inputs(op, block, no_grad_set,
                              seq_outers + boots + closure)
    if not diff:
        return []
    return [{
        "type": "recurrent_grad",
        "inputs": {"X": diff,
                   "Out" + GRAD_SUFFIX: [n + GRAD_SUFFIX
                                         for n in op.output("Out")]},
        "outputs": {"X" + GRAD_SUFFIX: [n + GRAD_SUFFIX for n in diff]},
        "attrs": {k: op.attrs[k] for k in
                  ("sub_block", "step_inputs", "memories", "step_outputs")}
        | ({"lengths": op.attrs["lengths"]} if "lengths" in op.attrs
           else {}) | {"out_hint": list(op.output("Out"))},
    }]


def _scan_recurrent(ctx, env, attrs, program):
    """Shared forward computation: returns {outer_stacked_name: value}."""
    sub = program.blocks[attrs["sub_block"]]
    step_inputs = attrs["step_inputs"]
    memories = attrs["memories"]
    step_outputs = attrs["step_outputs"]
    lengths = env[attrs["lengths"]] if attrs.get("lengths") else None

    xs = {inner: env[outer] for outer, inner in step_inputs}
    mem = {pre: env[boot] for boot, pre, _ in memories}
    T = next(iter(xs.values())).shape[0]
    ys = {inner: [] for inner, _ in step_outputs}
    for t in range(T):
        benv = dict(env)
        benv.update({inner: x[t] for inner, x in xs.items()})
        benv.update(mem)
        _run_block(sub, benv, ctx)
        if lengths is not None:
            active = t < lengths.reshape(-1)  # [B]
        new = {}
        for boot, pre, post in memories:
            v = benv[post]
            if lengths is not None:
                mask = active.reshape((-1,) + (1,) * (v.ndim - 1))
                v = torch.where(mask, v, mem[pre])
            new[pre] = v
        mem = new
        for inner, _ in step_outputs:
            v = benv[inner]
            if lengths is not None:
                mask = active.reshape((-1,) + (1,) * (v.ndim - 1))
                v = torch.where(mask, v, torch.zeros_like(v))
            ys[inner].append(v)
    return {outer: torch.stack(ys[inner]) for inner, outer in step_outputs}


@register_macro_op("recurrent", grad_maker=_recurrent_grad_maker)
def _recurrent(ctx, op, env):
    program = op.block.program
    sub = program.blocks[op.attrs["sub_block"]]
    tag = f"@rnn@{sub.idx}@"
    env[tag + "rng"] = _rng_state(ctx)
    # stash closure entry values: a later op may overwrite a read var
    # before the grad op replays the loop
    for n in _block_outer_reads(program, sub) + \
            [o for o, _ in op.attrs["step_inputs"]] + \
            [b for b, _, _ in op.attrs["memories"]]:
        if n in env:
            env.setdefault(tag + "in@" + n, env[n])
    outs = _scan_recurrent(_sub_ctx(ctx), env, op.attrs, program)
    for outer, v in outs.items():
        env[outer] = v


@register_macro_op("recurrent_grad")
def _recurrent_grad(ctx, op, env):
    program = op.block.program
    sub = program.blocks[op.attrs["sub_block"]]
    tag = f"@rnn@{sub.idx}@"
    diff = op.input("X")
    primals = [env.get(tag + "in@" + n, env.get(n)) for n in diff]
    out_names = op.attrs["out_hint"]
    gnames = op.input("Out" + GRAD_SUFFIX)
    rng = env[tag + "rng"]

    def f(*vals):
        outer = dict(env)
        for n in diff:
            if tag + "in@" + n in env:
                outer[n] = env[tag + "in@" + n]
        outer.update(dict(zip(diff, vals)))
        outs = _scan_recurrent(_sub_ctx(ctx, rng, differentiable=True),
                               outer, op.attrs, program)
        return tuple(outs[n] for n in out_names if _is_inexact(outs[n]))

    # recompute which outputs are float to align cotangents
    kept = [g for n, g in zip(out_names, gnames)
            if n in env and _is_inexact(env[n])]
    _vjp_into_env(op, env, f, primals, kept)


# ---------------------------------------------------------------------------
# reference-IR boundary + tensor-array ops (controlflow/ in the reference)
# ---------------------------------------------------------------------------

@register_macro_op("feed", grad_free=True)
def _feed(ctx, op, env):
    """reference: controlflow/feed_op.cc — copy feed-holder column into the
    target var. The executor binds feeds by NAME before running, so when a
    reference-shaped program carries explicit feed ops the target is
    already in env; this rule just validates that."""
    out = op.output("Out")[0]
    if out not in env:
        raise RuntimeError(
            f"feed op targets {out!r} but no feed was bound for it; pass "
            f"feed={{{out!r}: value}} to Executor.run")


@register_macro_op("fetch", grad_free=True)
def _fetch(ctx, op, env):
    """reference: controlflow/fetch_op.cc — expose a var for fetching.
    Fetching here is by name via fetch_list; make the fetch-holder name an
    alias of the value so either name works."""
    out = op.output("Out")[0]
    x = op.input("X")[0]
    if x in env:
        env[out] = env[x]


@register_macro_op("get_places", grad_free=True)
def _get_places(ctx, op, env):
    """reference: controlflow/get_places_op.cc — enumerate devices: the
    visible CUDA cards when the run is on one, else 1 (the CPU), as an
    int32 vector."""
    n = int(op.attrs.get("device_count", 0) or 0)
    if n == 0:
        n = torch.cuda.device_count() if ctx.device.type == "cuda" else 1
    env[op.output("Out")[0]] = torch.arange(n, dtype=torch.int32,
                                            device=ctx.device)


@register_macro_op("write_to_array", grad_free=True)
def _write_to_array(ctx, op, env):
    """reference: controlflow/tensor_array_read_write_op.cc WriteToArrayOp.
    A tensor array is a python tuple in the environment (lod_array_ops.py);
    the subscript I is read on the host."""
    arr = list(env.get(op.output("Out")[0], ()))
    i = _static_index(op, op.input("I")[0], env, "write_to_array")
    x = env[op.input("X")[0]]
    if i == len(arr):
        arr.append(x)
    elif i < len(arr):
        arr[i] = x
    else:  # sparse write: pad the gap like the reference's resize
        arr.extend([torch.zeros_like(x)] * (i - len(arr)) + [x])
    env[op.output("Out")[0]] = tuple(arr)


@register_macro_op("read_from_array", grad_free=True)
def _read_from_array(ctx, op, env):
    """reference: controlflow/tensor_array_read_write_op.cc ReadFromArrayOp."""
    arr = env[op.input("X")[0]]
    i = _static_index(op, op.input("I")[0], env, "read_from_array")
    env[op.output("Out")[0]] = arr[i]


def _const_fold_int(block, name, upto_idx, memo=None):
    """Build-time evaluation of an int scalar var: walk the block backwards
    from position upto_idx to the last writer of `name` and fold
    fill_constant / increment / assign chains. Returns None if the value is
    genuinely data-dependent."""
    if memo is None:
        memo = {}
    if name in memo:
        return memo[name]
    val = None
    for i in range(upto_idx - 1, -1, -1):
        producer = block.ops[i]
        if name not in producer.output_names():
            continue
        t = producer.type
        if t == "fill_constant":
            val = int(producer.attrs["value"])
        elif t == "increment":
            src = _const_fold_int(block, producer.input("X")[0], i, memo)
            if src is not None:
                val = src + int(producer.attrs.get("step", 1))
        elif t == "assign":
            val = _const_fold_int(block, producer.input("X")[0], i, memo)
        break
    memo[name] = val
    return val


def _static_index(op, index_name, env, what):
    # the value in env is concrete in eager mode (one host read); the IR
    # constant fold of JAX's traced path stays as the fallback for an
    # index the environment does not hold
    v = env.get(index_name)
    if isinstance(v, torch.Tensor):
        return int(v.reshape(()).item())
    idx = op.block.ops.index(op) if op in op.block.ops else len(op.block.ops)
    folded = _const_fold_int(op.block, index_name, idx)
    if folded is not None:
        return folded
    raise NotImplementedError(
        f"{what} needs a static index (static shapes); build loops with "
        "layers.StaticRNN/DynamicRNN instead of dynamic array subscripts")
