"""Knowledge distillation (reference: contrib/slim/distillation/ —
DistillationStrategy merges teacher+student graphs and adds soft-label /
FSP / l2 losses).

Port of `paddle_tpu/contrib/slim/distillation.py` (a copy over the
port's layers DSL)."""

from __future__ import annotations

from typing import Dict, Optional

from ... import layers
from ...framework.core import Operator, Parameter, Program

__all__ = ["merge_teacher_program", "soft_label_loss", "l2_distill_loss",
           "fsp_loss", "multi_teacher_soft_label_loss"]


def merge_teacher_program(teacher: Program, student: Program,
                          prefix: str = "teacher_") -> Dict[str, str]:
    """Copy the teacher's forward graph into the student program with
    prefixed, frozen vars (reference distillation merge). Data vars with
    the same name are SHARED (both nets read the same feed). Returns
    {teacher var name: merged name}."""
    sblk = student.global_block
    tblk = teacher.global_block
    mapping: Dict[str, str] = {}
    for v in tblk.vars.values():
        if v.is_data and v.name in sblk.vars:
            mapping[v.name] = v.name  # shared feed
            continue
        new = prefix + v.name
        mapping[v.name] = new
        if isinstance(v, Parameter):
            p = sblk.create_parameter(name=new, shape=v.shape,
                                      dtype=v.dtype, trainable=False)
            p.stop_gradient = True
        else:
            sblk.create_var(name=new, shape=v.shape, dtype=v.dtype,
                            persistable=v.persistable,
                            stop_gradient=True, is_data=v.is_data)
    for op in tblk.ops:
        if op.type in ("feed", "fetch"):
            continue
        ins = {s: [mapping[n] for n in ns] for s, ns in op.inputs.items()}
        outs = {s: [mapping[n] for n in ns] for s, ns in op.outputs.items()}
        sblk.ops.append(Operator(sblk, op.type, ins, outs, dict(op.attrs)))
    student._bump_version()
    return mapping


def soft_label_loss(student_logits, teacher_logits, temperature: float = 1.0):
    """KL(teacher || student) on temperature-softened distributions
    (reference soft_label_loss)."""
    t = float(temperature)
    s = layers.log_softmax(layers.scale(student_logits, scale=1.0 / t))
    p = layers.softmax(layers.scale(teacher_logits, scale=1.0 / t))
    # KL = sum p * (log p - log s); constant log p term kept for a true KL
    logp = layers.log_softmax(layers.scale(teacher_logits, scale=1.0 / t))
    kl = layers.reduce_sum(p * (logp - s), dim=-1)
    return layers.scale(layers.mean(kl), scale=t * t)


def l2_distill_loss(student_feat, teacher_feat):
    return layers.mean(layers.square(student_feat - teacher_feat))


def fsp_loss(s_in, s_out, t_in, t_out):
    """Flow-of-solution-procedure loss (reference fsp_loss): L2 between
    layer-pair Gram matrices."""
    def _fsp(a, b):
        # [b, c1, h, w], [b, c2, h, w] -> [b, c1, c2]
        n = a.shape[1]
        m = b.shape[1]
        af = layers.reshape(a, [0, n, -1])
        bf = layers.reshape(b, [0, m, -1])
        g = layers.matmul(af, layers.transpose(bf, [0, 2, 1]))
        hw = a.shape[2] * a.shape[3]
        return layers.scale(g, scale=1.0 / float(hw))

    return layers.mean(layers.square(_fsp(s_in, s_out) - _fsp(t_in, t_out)))


def multi_teacher_soft_label_loss(student_logits, teacher_logits_list,
                                  weights=None, temperature: float = 1.0):
    """Weighted ensemble distillation over several teachers (reference:
    slim's multi-teacher DistillationStrategy): mean of per-teacher
    soft-label KLs, weighted by `weights` (uniform by default)."""
    if not teacher_logits_list:
        raise ValueError("need at least one teacher")
    if weights is None:
        weights = [1.0 / len(teacher_logits_list)] * len(teacher_logits_list)
    if len(weights) != len(teacher_logits_list):
        raise ValueError("one weight per teacher")
    total = None
    for w, t_logits in zip(weights, teacher_logits_list):
        term = layers.scale(
            soft_label_loss(student_logits, t_logits, temperature),
            scale=float(w))
        total = term if total is None else layers.elementwise_add(total,
                                                                  term)
    return total
