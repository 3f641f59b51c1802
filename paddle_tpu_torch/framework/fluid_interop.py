"""Fluid-format interoperability: ProgramDesc protobuf + save_op tensor codec.

The reference serializes programs as a proto2 `ProgramDesc`
(reference: paddle/fluid/framework/framework.proto:184) and parameters in the
save_op stream format (reference: paddle/fluid/framework/tensor_util.cc:383
TensorToStream, lod_tensor.cc:219 SerializeToStream, operators/save_combine_op.h).
This module is a hand-rolled proto2 wire codec for exactly that schema plus the
tensor stream layout, bridging both into/out of the repo's JSON IR so that
Fluid-era artifacts can be imported and our models exported for Fluid
tooling. A copy of `paddle_tpu/framework/fluid_interop.py` (struct and
numpy only), so both packages write the same bytes.  No protobuf runtime or generated code is used at import/export time;
tests cross-check the bytes against an independently-built decoder.

Wire-format facts encoded here (all from framework.proto / version.h):
  * kCurProgramVersion = 0, kCurTensorVersion = 0 (version.h:28,36).
  * ProgramDesc{ blocks=1 rep, version=2 }; Version{ version=1 int64 }.
  * BlockDesc{ idx=1 req, parent_idx=2 req, vars=3 rep, ops=4 rep,
    forward_block_idx=5 (default -1) }.
  * VarDesc{ name=1, type=2 (VarType), persistable=3 }.
  * VarType{ type=1 enum, selected_rows=2 TensorDesc, lod_tensor=3
    LoDTensorDesc, tensor_array=4, reader=5, tuple=7 }.
  * TensorDesc{ data_type=1 enum, dims=2 rep int64 }.
  * LoDTensorDesc{ tensor=1, lod_level=2 }.
  * OpDesc{ inputs=1 rep Var, outputs=2 rep Var, type=3, attrs=4 rep Attr,
    is_target=5 }; Var{ parameter=1, arguments=2 rep };
    Attr{ name=1, type=2, i=3, f=4, s=5, ints=6, floats=7, strings=8, b=10,
    bools=11, block_idx=12, l=13, blocks_idx=14, longs=15 }.
  * Tensor stream (tensor_util.cc:383): uint32 version(0); int32 proto size;
    TensorDesc bytes; raw data.  LoDTensor stream (lod_tensor.cc:219) prefixes
    uint32 version(0) and the LoD table: uint64 n_levels, then per level a
    uint64 byte-size followed by that many bytes of uint64 offsets.
  * A save_combine file is these streams concatenated in input order
    (save_combine_op.h Compute loop); fluid io.py:242 orders by sorted name.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "program_to_fluid_bytes", "program_from_fluid_bytes",
    "lod_tensor_to_bytes", "lod_tensor_from_bytes", "read_lod_tensor_stream",
    "save_combine_bytes", "load_combine_bytes",
]

# --------------------------------------------------------------------------
# proto2 wire primitives
# --------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _enc_varint(value: int) -> bytes:
    if value < 0:
        # proto2 int32/int64: negative values are 64-bit two's complement
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt stream)")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _tag(field: int, wire: int) -> bytes:
    return _enc_varint((field << 3) | wire)


def _enc_len(field: int, payload: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _enc_varint(len(payload)) + payload


def _enc_int(field: int, value: int) -> bytes:
    return _tag(field, _WIRE_VARINT) + _enc_varint(int(value))


def _enc_bool(field: int, value: bool) -> bytes:
    return _enc_int(field, 1 if value else 0)


def _enc_float(field: int, value: float) -> bytes:
    return _tag(field, _WIRE_32BIT) + struct.pack("<f", float(value))


def _enc_str(field: int, value: str) -> bytes:
    return _enc_len(field, value.encode("utf-8"))


class _Msg:
    """Decoded proto2 message: field number -> list of raw values.

    Varint fields decode to int, 32-bit to the raw 4 bytes, length-delimited
    to bytes.  Schema interpretation happens in the callers.
    """

    def __init__(self, data: bytes):
        self.fields: Dict[int, List[Any]] = {}
        pos = 0
        end = len(data)
        while pos < end:
            key, pos = _dec_varint(data, pos)
            field, wire = key >> 3, key & 7
            if wire == _WIRE_VARINT:
                val, pos = _dec_varint(data, pos)
            elif wire == _WIRE_LEN:
                n, pos = _dec_varint(data, pos)
                val = data[pos:pos + n]
                pos += n
            elif wire == _WIRE_32BIT:
                val = data[pos:pos + 4]
                pos += 4
            elif wire == _WIRE_64BIT:
                val = data[pos:pos + 8]
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")
            self.fields.setdefault(field, []).append(val)

    def ints(self, field: int) -> List[int]:
        # proto2 repeated scalars default to unpacked, but accept packed too.
        out: List[int] = []
        for v in self.fields.get(field, []):
            if isinstance(v, int):
                out.append(_signed64(v))
            else:  # packed: run of varints in one length-delimited payload
                pos = 0
                while pos < len(v):
                    x, pos = _dec_varint(v, pos)
                    out.append(_signed64(x))
        return out

    def int(self, field: int, default: Optional[int] = None) -> Optional[int]:
        vals = self.ints(field)
        return vals[-1] if vals else default

    def floats(self, field: int) -> List[float]:
        out: List[float] = []
        for v in self.fields.get(field, []):
            if isinstance(v, bytes) and len(v) == 4:
                out.append(struct.unpack("<f", v)[0])
            elif isinstance(v, bytes):  # packed fixed32 run
                out.extend(struct.unpack(f"<{len(v)//4}f", v))
        return out

    def strs(self, field: int) -> List[str]:
        return [v.decode("utf-8") for v in self.fields.get(field, [])]

    def str(self, field: int, default: str = "") -> str:
        vals = self.strs(field)
        return vals[-1] if vals else default

    def msgs(self, field: int) -> List["_Msg"]:
        return [_Msg(v) for v in self.fields.get(field, [])]

    def msg(self, field: int) -> Optional["_Msg"]:
        raw = self.fields.get(field)
        return _Msg(raw[-1]) if raw else None


# --------------------------------------------------------------------------
# Schema constants (framework.proto)
# --------------------------------------------------------------------------

# AttrType enum
ATTR_INT, ATTR_FLOAT, ATTR_STRING, ATTR_INTS, ATTR_FLOATS, ATTR_STRINGS = range(6)
ATTR_BOOLEAN, ATTR_BOOLEANS, ATTR_BLOCK, ATTR_LONG, ATTR_BLOCKS, ATTR_LONGS = range(6, 12)

# VarType.Type enum values used for data + var kinds
_VT = {
    "bool": 0, "int16": 1, "int32": 2, "int64": 3, "float16": 4,
    "float32": 5, "float64": 6, "uint8": 20, "int8": 21,
}
_VT_REV = {v: k for k, v in _VT.items()}
VT_LOD_TENSOR = 7
VT_SELECTED_ROWS = 8
VT_FEED_MINIBATCH = 9
VT_FETCH_LIST = 10
VT_STEP_SCOPES = 11
VT_LOD_RANK_TABLE = 12
VT_LOD_TENSOR_ARRAY = 13
VT_READER = 15
VT_RAW = 17

_TYPE_TO_VT = {
    "lod_tensor": VT_LOD_TENSOR,
    "selected_rows": VT_SELECTED_ROWS,
    "feed_minibatch": VT_FEED_MINIBATCH,
    "fetch_list": VT_FETCH_LIST,
    "step_scopes": VT_STEP_SCOPES,
    "lod_rank_table": VT_LOD_RANK_TABLE,
    "lod_tensor_array": VT_LOD_TENSOR_ARRAY,
    "reader": VT_READER,
    "raw": VT_RAW,
}
_VT_TO_TYPE = {v: k for k, v in _TYPE_TO_VT.items()}

# numpy dtype <-> VarType data_type. bfloat16 has no Fluid-1.x proto value;
# exported bf16 tensors are upcast to fp32 (documented in PARITY.md).
_NP_OF_VT = {0: np.bool_, 1: np.int16, 2: np.int32, 3: np.int64,
             4: np.float16, 5: np.float32, 6: np.float64,
             20: np.uint8, 21: np.int8}

# Attrs that reference sub-blocks by index in the repo IR.
_BLOCK_ATTRS = ("sub_block", "sub_block_t", "sub_block_f", "block")

_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


# --------------------------------------------------------------------------
# Export: repo Program -> ProgramDesc bytes
# --------------------------------------------------------------------------

def _enc_tensor_desc(dtype: str, dims: Sequence[int]) -> bytes:
    if dtype == "bfloat16":
        dtype = "float32"
    out = _enc_int(1, _VT[dtype])
    for d in dims:
        out += _enc_int(2, int(d))
    return out


def _enc_var_type(var) -> bytes:
    vt = _TYPE_TO_VT.get(var.type, VT_LOD_TENSOR)
    out = _enc_int(1, vt)
    dims = list(var.shape) if var.shape is not None else []
    tdesc = _enc_tensor_desc(var.dtype, dims)
    if vt == VT_SELECTED_ROWS:
        out += _enc_len(2, tdesc)
    elif vt == VT_LOD_TENSOR_ARRAY:
        lod_level = int(getattr(var, "lod_level", 0) or 0)
        out += _enc_len(4, _enc_len(1, tdesc) + _enc_int(2, lod_level))
    elif vt == VT_LOD_TENSOR:
        lod_level = int(getattr(var, "lod_level", 0) or 0)
        out += _enc_len(3, _enc_len(1, tdesc) + _enc_int(2, lod_level))
    return out


def _enc_var_desc(var) -> bytes:
    return (_enc_str(1, var.name)
            + _enc_len(2, _enc_var_type(var))
            + _enc_bool(3, bool(var.persistable)))


def _attr_wire_type(name: str, value) -> Tuple[int, Any]:
    """Infer the Fluid AttrType for a Python attr value.

    Booleans are checked before ints (bool is an int subclass); ints that
    overflow int32 become LONG/LONGS; numpy scalars/arrays are converted.
    Returns (attr_type, normalized_value) or (None, None) if inexpressible.
    """
    if name in _BLOCK_ATTRS and isinstance(value, (int, np.integer)) \
            and not isinstance(value, bool):
        return ATTR_BLOCK, int(value)
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if isinstance(value, (bool, np.bool_)):
        return ATTR_BOOLEAN, bool(value)
    if isinstance(value, (int, np.integer)):
        value = int(value)
        if _INT32_MIN <= value <= _INT32_MAX:
            return ATTR_INT, value
        return ATTR_LONG, value
    if isinstance(value, (float, np.floating)):
        return ATTR_FLOAT, float(value)
    if isinstance(value, str):
        return ATTR_STRING, value
    if isinstance(value, (list, tuple)):
        vals = list(value)
        if all(isinstance(v, (bool, np.bool_)) for v in vals) and vals:
            return ATTR_BOOLEANS, [bool(v) for v in vals]
        if all(isinstance(v, (int, np.integer)) and
               not isinstance(v, bool) for v in vals):
            ints = [int(v) for v in vals]
            if all(_INT32_MIN <= v <= _INT32_MAX for v in ints):
                return ATTR_INTS, ints
            return ATTR_LONGS, ints
        if all(isinstance(v, (int, float, np.integer, np.floating))
               and not isinstance(v, bool) for v in vals):
            return ATTR_FLOATS, [float(v) for v in vals]
        if all(isinstance(v, str) for v in vals):
            return ATTR_STRINGS, vals
    return None, None


def _enc_attr(name: str, value) -> Optional[bytes]:
    atype, value = _attr_wire_type(name, value)
    if atype is None:
        return None
    out = _enc_str(1, name) + _enc_int(2, atype)
    if atype == ATTR_INT:
        out += _enc_int(3, value)
    elif atype == ATTR_FLOAT:
        out += _enc_float(4, value)
    elif atype == ATTR_STRING:
        out += _enc_str(5, value)
    elif atype == ATTR_INTS:
        for v in value:
            out += _enc_int(6, v)
    elif atype == ATTR_FLOATS:
        for v in value:
            out += _enc_float(7, v)
    elif atype == ATTR_STRINGS:
        for v in value:
            out += _enc_str(8, v)
    elif atype == ATTR_BOOLEAN:
        out += _enc_bool(10, value)
    elif atype == ATTR_BOOLEANS:
        for v in value:
            out += _enc_bool(11, v)
    elif atype == ATTR_BLOCK:
        out += _enc_int(12, value)
    elif atype == ATTR_LONG:
        out += _enc_int(13, value)
    elif atype == ATTR_LONGS:
        for v in value:
            out += _enc_int(15, v)
    return out


def _enc_op_desc(op) -> bytes:
    out = b""
    for slot, names in op.inputs.items():
        payload = _enc_str(1, slot)
        for n in names:
            payload += _enc_str(2, n)
        out += _enc_len(1, payload)
    for slot, names in op.outputs.items():
        payload = _enc_str(1, slot)
        for n in names:
            payload += _enc_str(2, n)
        out += _enc_len(2, payload)
    out += _enc_str(3, op.type)
    for name in sorted(op.attrs):
        enc = _enc_attr(name, op.attrs[name])
        if enc is not None:
            out += _enc_len(4, enc)
    return out


def program_to_fluid_bytes(program) -> bytes:
    """Serialize a repo Program as a Fluid ProgramDesc (framework.proto:184)."""
    out = b""
    for block in program.blocks:
        payload = _enc_int(1, block.idx) + _enc_int(2, max(block.parent_idx, -1))
        for var in block.vars.values():
            payload += _enc_len(3, _enc_var_desc(var))
        for op in block.ops:
            payload += _enc_len(4, _enc_op_desc(op))
        out += _enc_len(1, payload)
    out += _enc_len(2, _enc_int(1, 0))  # Version{version=0} (version.h:28)
    return out


# --------------------------------------------------------------------------
# Import: ProgramDesc bytes -> repo Program
# --------------------------------------------------------------------------

def _dec_attr(msg: _Msg) -> Tuple[str, Any]:
    name = msg.str(1)
    atype = msg.int(2)
    if atype == ATTR_INT:
        val: Any = msg.int(3, 0)
    elif atype == ATTR_FLOAT:
        vals = msg.floats(4)
        val = vals[-1] if vals else 0.0
    elif atype == ATTR_STRING:
        val = msg.str(5)
    elif atype == ATTR_INTS:
        val = msg.ints(6)
    elif atype == ATTR_FLOATS:
        val = msg.floats(7)
    elif atype == ATTR_STRINGS:
        val = msg.strs(8)
    elif atype == ATTR_BOOLEAN:
        val = bool(msg.int(10, 0))
    elif atype == ATTR_BOOLEANS:
        val = [bool(v) for v in msg.ints(11)]
    elif atype == ATTR_BLOCK:
        val = msg.int(12, 0)
    elif atype == ATTR_LONG:
        val = msg.int(13, 0)
    elif atype == ATTR_BLOCKS:
        val = msg.ints(14)
    elif atype == ATTR_LONGS:
        val = msg.ints(15)
    else:
        val = None
    return name, val


def _dec_var(block, msg: _Msg):
    from .core import Parameter, Variable
    name = msg.str(1)
    vt_msg = msg.msg(2)
    vt = vt_msg.int(1, VT_LOD_TENSOR) if vt_msg else VT_LOD_TENSOR
    shape = None
    dtype = "float32"
    lod_level = 0
    tdesc = None
    if vt_msg is not None:
        if vt == VT_SELECTED_ROWS:
            tdesc = vt_msg.msg(2)
        elif vt == VT_LOD_TENSOR_ARRAY:
            wrapper = vt_msg.msg(4)
            if wrapper:
                tdesc = wrapper.msg(1)
                lod_level = wrapper.int(2, 0)
        else:
            wrapper = vt_msg.msg(3)
            if wrapper:
                tdesc = wrapper.msg(1)
                lod_level = wrapper.int(2, 0)
    if tdesc is not None:
        dtype = _VT_REV.get(tdesc.int(1, 5), "float32")
        shape = tdesc.ints(2)
    persistable = bool(msg.int(3, 0))
    if persistable and vt == VT_LOD_TENSOR and shape:
        # Fluid VarDesc doesn't distinguish Parameter from other persistable
        # lod_tensors; treat them as Parameters so all_parameters() /
        # save_params work on imported programs (same as the JSON path's
        # is_parameter flag restores).
        var = Parameter(block, name, shape, dtype=dtype)
    else:
        var = Variable(block, name, shape=shape, dtype=dtype,
                       persistable=persistable,
                       type=_VT_TO_TYPE.get(vt, "lod_tensor"))
    var.lod_level = lod_level
    return var


def program_from_fluid_bytes(data: bytes):
    """Parse Fluid ProgramDesc bytes into a repo Program (JSON-IR classes)."""
    from .core import Block, Operator, Program
    top = _Msg(bytes(data))
    program = Program()
    program.blocks = []
    for bmsg in top.msgs(1):
        block = Block(program, bmsg.int(1, 0), bmsg.int(2, -1))
        for vmsg in bmsg.msgs(3):
            var = _dec_var(block, vmsg)
            block.vars[var.name] = var
        for omsg in bmsg.msgs(4):
            inputs = {m.str(1): m.strs(2) for m in omsg.msgs(1)}
            outputs = {m.str(1): m.strs(2) for m in omsg.msgs(2)}
            attrs = dict(_dec_attr(m) for m in omsg.msgs(4))
            block.ops.append(Operator(block, omsg.str(3), inputs, outputs,
                                      attrs))
        program.blocks.append(block)
    if not program.blocks:
        raise ValueError("ProgramDesc has no blocks (not a Fluid program?)")
    return program


# --------------------------------------------------------------------------
# Tensor stream codec (tensor_util.cc:383 / lod_tensor.cc:219)
# --------------------------------------------------------------------------

def lod_tensor_to_bytes(array: np.ndarray,
                        lod: Optional[Sequence[Sequence[int]]] = None) -> bytes:
    """One LoDTensor in the save_op stream format.

    Layout: uint32 tensor-version(0) | uint64 n_lod_levels |
    per level (uint64 nbytes + uint64 offsets...) | uint32 version(0) |
    int32 desc-size | TensorDesc proto | raw data (C-contiguous).
    """
    array = np.ascontiguousarray(array)
    if "bfloat16" in str(array.dtype):
        array = array.astype(np.float32)
    dtype = array.dtype.name
    if dtype not in _VT:
        raise ValueError(f"dtype {dtype} has no Fluid VarType value")
    out = struct.pack("<I", 0)  # LoDTensor version
    levels = list(lod or [])
    out += struct.pack("<Q", len(levels))
    for level in levels:
        offs = np.asarray(level, dtype=np.uint64)
        out += struct.pack("<Q", offs.nbytes) + offs.tobytes()
    out += struct.pack("<I", 0)  # Tensor version
    desc = _enc_tensor_desc(dtype, array.shape)
    out += struct.pack("<i", len(desc)) + desc
    out += array.tobytes()
    return out


def read_lod_tensor_stream(data: bytes, pos: int = 0
                           ) -> Tuple[np.ndarray, List[List[int]], int]:
    """Decode one LoDTensor stream at `pos`; returns (array, lod, new_pos)."""
    (tv,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if tv != 0:
        raise ValueError(f"unsupported LoDTensor version {tv}")
    (n_levels,) = struct.unpack_from("<Q", data, pos)
    pos += 8
    lod: List[List[int]] = []
    for _ in range(n_levels):
        (nbytes,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        offs = np.frombuffer(data, dtype=np.uint64, count=nbytes // 8,
                             offset=pos)
        pos += nbytes
        lod.append([int(o) for o in offs])
    (ver,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if ver != 0:
        raise ValueError(f"unsupported Tensor version {ver}")
    (desc_size,) = struct.unpack_from("<i", data, pos)
    pos += 4
    desc = _Msg(bytes(data[pos:pos + desc_size]))
    pos += desc_size
    np_dtype = np.dtype(_NP_OF_VT[desc.int(1, 5)])
    dims = desc.ints(2)
    count = int(np.prod(dims)) if dims else 1
    array = np.frombuffer(data, dtype=np_dtype, count=count, offset=pos)
    pos += count * np_dtype.itemsize
    return array.reshape(dims).copy(), lod, pos


def lod_tensor_from_bytes(data: bytes) -> Tuple[np.ndarray, List[List[int]]]:
    array, lod, pos = read_lod_tensor_stream(data, 0)
    if pos != len(data):
        raise ValueError(f"trailing bytes in tensor file ({len(data)-pos})")
    return array, lod


def save_combine_bytes(arrays: Sequence[np.ndarray]) -> bytes:
    """Concatenated streams, caller supplies sorted-name order
    (save_combine_op.h; ordering: fluid io.py:242)."""
    return b"".join(lod_tensor_to_bytes(a) for a in arrays)


def load_combine_bytes(data: bytes, count: Optional[int] = None
                       ) -> List[np.ndarray]:
    out: List[np.ndarray] = []
    pos = 0
    while pos < len(data) and (count is None or len(out) < count):
        array, _lod, pos = read_lod_tensor_stream(data, pos)
        out.append(array)
    return out
