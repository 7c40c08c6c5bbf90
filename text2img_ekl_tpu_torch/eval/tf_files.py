"""Readers of TensorFlow's two weight formats, in pure Python.

The port runs where neither TensorFlow nor the protobuf package is
installed, so it decodes the files itself:

- ``TensorBundle``: a TF2 / TF1-V2 checkpoint (``tf.train.Saver``
  writes ``<prefix>.index`` and ``<prefix>.data-0000N-of-0000M``). The
  index is a LevelDB-format table (tensorflow/core/lib/io/table.cc): a
  48-byte footer with the index block's handle and the magic number, data
  blocks of prefix-compressed entries closed by a restart array, each
  block followed by a 5-byte trailer (compression type, masked CRC32C). Its
  values are ``BundleHeaderProto`` (key "") and ``BundleEntryProto``s
  (dtype, shape, shard_id, offset, size); the tensor bytes sit in the data
  shards. TensorFlow writes these tables uncompressed; a block that says
  Snappy raises rather than being misread.
- ``read_frozen_graph_consts``: a frozen ``GraphDef`` (``.pb``): every
  ``Const`` node's ``TensorProto`` as ``tf.make_ndarray`` returns it (from
  ``tensor_content``, or from the repeated ``*_val`` fields, the last value
  repeated to fill the shape), and the ``scale_after_normalization`` flags
  of ``BatchNormWithGlobalNormalization`` nodes.

Field numbers are those of tensorflow/core/framework/{graph,node_def,
attr_value,tensor,tensor_shape,types}.proto and
tensorflow/core/protobuf/tensor_bundle.proto.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

# --------------------------------------------------------------------------
# protobuf wire format


def _varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError('malformed varint at byte %d' % pos)


def _signed(v: int) -> int:
    """int32 / int64 fields: negative values are 64-bit two's complement."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _fields(buf) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a message: an int for varints,
    a memoryview for fixed32 / fixed64 / length-delimited fields."""
    buf = memoryview(buf)
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError('wire type %d (groups) is not supported' % wire)
        if pos > end:
            raise ValueError('truncated protobuf message')
        yield num, wire, value


def _packed_varints(wire: int, value) -> List[int]:
    if wire == 0:
        return [value]
    out, pos = [], 0
    while pos < len(value):
        v, pos = _varint(value, pos)
        out.append(v)
    return out


def _shape(buf) -> List[int]:
    """TensorShapeProto: dim = 2 (Dim: size = 1)."""
    dims = []
    for num, _, value in _fields(buf):
        if num == 2:
            size = 0
            for n2, _, v2 in _fields(value):
                if n2 == 1:
                    size = _signed(v2)
            dims.append(size)
    return dims


# --------------------------------------------------------------------------
# tensors

# DataType enum -> numpy dtype (types.proto); DT_STRING is 7
_DTYPES = {1: '<f4', 2: '<f8', 3: '<i4', 4: 'u1', 5: '<i2', 6: 'i1',
           8: '<c8', 9: '<i8', 10: '?', 17: '<u2', 18: '<c16', 19: '<f2',
           22: '<u4', 23: '<u8'}
DT_STRING = 7
# TensorProto's repeated value field for each dtype, as tf.make_ndarray
# reads them: (field number, wire encoding of one element)
_VAL_FIELD = {1: (5, '<f4'), 2: (6, '<f8'), 3: (7, 'varint'),
              4: (7, 'varint'), 5: (7, 'varint'), 6: (7, 'varint'),
              17: (7, 'varint'), 9: (10, 'varint'), 22: (16, 'varint'),
              23: (17, 'varint'), 10: (11, 'varint'), 19: (13, 'varint'),
              8: (9, '<f4'), 18: (12, '<f8')}


def _np_dtype(dtype: int):
    if dtype == DT_STRING:
        return np.dtype(object)
    if dtype not in _DTYPES:
        raise TypeError('unsupported tensor dtype %d' % dtype)
    return np.dtype(_DTYPES[dtype])


def _make_ndarray(buf) -> np.ndarray:
    """A TensorProto -> numpy, as ``tf.make_ndarray`` builds it."""
    dtype, shape, content = 0, [], b''
    vals: Dict[int, list] = {}
    for num, wire, value in _fields(buf):
        if num == 1:
            dtype = value
        elif num == 2:
            shape = _shape(value)
        elif num == 4:
            content = value
        else:
            vals.setdefault(num, []).append((wire, value))
    np_dtype = _np_dtype(dtype)
    count = int(np.prod(shape, dtype=np.int64))
    if len(content):
        if dtype == DT_STRING:
            raise TypeError('a string tensor in tensor_content')
        return np.frombuffer(content, np_dtype).copy().reshape(shape)
    if dtype == DT_STRING:
        values = [bytes(v) for _, v in vals.get(8, [])]
        if count > len(values):
            values += [values[-1] if values else b''] * (count - len(values))
        return np.array(values, dtype=object).reshape(shape)
    field, enc = _VAL_FIELD[dtype]
    raw = vals.get(field, [])
    if enc == 'varint':
        ints = [x for wire, v in raw for x in _packed_varints(wire, v)]
        if dtype == 19:   # half_val holds float16 bit patterns
            values = np.array(ints, np.uint16).view(np.float16)
        elif dtype in (22, 23, 10):
            values = np.array(ints, np.uint64).astype(np_dtype)
        else:
            values = np.array([_signed(x) for x in ints],
                              np.int64).astype(np_dtype)
    else:
        values = np.frombuffer(b''.join(bytes(v) for _, v in raw), enc)
        if dtype in (8, 18):  # (real, imaginary) pairs
            values = values[0::2] + 1j * values[1::2]
        values = values.astype(np_dtype)
    if values.size == 0:
        return np.zeros(shape, np_dtype)
    if values.size != count:
        values = np.pad(values, (0, count - values.size), 'edge')
    return values.reshape(shape)


# --------------------------------------------------------------------------
# frozen GraphDef


def read_frozen_graph_consts(pb_path: str
                             ) -> Tuple[Dict[str, np.ndarray], List[bool]]:
    """Every decodable ``Const`` node's value by node name (a node whose
    value does not decode is skipped, as the JAX loader skips what
    ``tf.make_ndarray`` refuses), and the ``scale_after_normalization``
    flag of each ``BatchNormWithGlobalNormalization`` node."""
    with open(pb_path, 'rb') as f:
        data = f.read()
    consts: Dict[str, np.ndarray] = {}
    flags: List[bool] = []
    for num, _, node in _fields(data):   # GraphDef: node = 1
        if num != 1:
            continue
        name, op, attrs = '', '', {}
        for n2, _, v2 in _fields(node):  # NodeDef: name 1, op 2, attr 5
            if n2 == 1:
                name = bytes(v2).decode()
            elif n2 == 2:
                op = bytes(v2).decode()
            elif n2 == 5:
                key, attr = '', None
                for n3, _, v3 in _fields(v2):  # map entry: key 1, value 2
                    if n3 == 1:
                        key = bytes(v3).decode()
                    elif n3 == 2:
                        attr = v3
                attrs[key] = attr
        if op == 'Const':
            tensor = None
            for n3, _, v3 in _fields(attrs.get('value') or b''):
                if n3 == 8:   # AttrValue.tensor
                    tensor = v3
            try:
                consts[name] = _make_ndarray(tensor if tensor is not None
                                             else b'')
            except (TypeError, ValueError, KeyError):
                pass
        elif op == 'BatchNormWithGlobalNormalization':
            b = False
            for n3, _, v3 in _fields(
                    attrs.get('scale_after_normalization') or b''):
                if n3 == 5:   # AttrValue.b
                    b = bool(v3)
            flags.append(b)
    return consts, flags


# --------------------------------------------------------------------------
# LevelDB-format table and tensor bundle

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_BYTES = 48
_COMPRESSION = {0: None, 1: 'Snappy'}


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    crc = 0xFFFFFFFF
    for b in bytes(data):
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _unmask(masked: int) -> int:
    rot = (masked - 0xA282EAD8) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


def _block(data: bytes, offset: int, size: int, where: str) -> memoryview:
    """One table block, its trailer checked: compression type, then the
    masked CRC32C of the block and that type byte."""
    if offset + size + 5 > len(data):
        raise ValueError('%s: block at %d runs past the file' % (where,
                                                                offset))
    kind = data[offset + size]
    if kind not in _COMPRESSION:
        raise ValueError('%s: unknown block compression type %d'
                         % (where, kind))
    if _COMPRESSION[kind]:
        raise NotImplementedError(
            '%s: a %s-compressed table block; TensorFlow writes checkpoint '
            'indexes uncompressed and this reader decodes only those'
            % (where, _COMPRESSION[kind]))
    crc, = struct.unpack_from('<I', data, offset + size + 1)
    if crc32c(data[offset:offset + size + 1]) != _unmask(crc):
        raise ValueError('%s: block at %d fails its CRC32C' % (where,
                                                               offset))
    return memoryview(data)[offset:offset + size]


def _block_entries(block: memoryview) -> Iterator[Tuple[bytes, memoryview]]:
    """(key, value) of a block: each entry is varint shared, varint
    non-shared, varint value length, the key's new suffix and the value;
    the block ends with its restart offsets and their count (uint32s)."""
    n_restarts, = struct.unpack_from('<I', block, len(block) - 4)
    end = len(block) - 4 - 4 * n_restarts
    pos, key = 0, b''
    while pos < end:
        shared, pos = _varint(block, pos)
        fresh, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + bytes(block[pos:pos + fresh])
        pos += fresh
        yield key, block[pos:pos + vlen]
        pos += vlen


def _table_entries(path: str) -> Iterator[Tuple[bytes, memoryview]]:
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < _FOOTER_BYTES:
        raise ValueError('%s is too short for a table' % path)
    footer = memoryview(data)[-_FOOTER_BYTES:]
    magic, = struct.unpack_from('<Q', footer, 40)
    if magic != _TABLE_MAGIC:
        raise ValueError('%s is not a TensorFlow table (bad magic)' % path)
    _, pos = _varint(footer, 0)          # metaindex handle: offset, size
    _, pos = _varint(footer, pos)
    index_off, pos = _varint(footer, pos)
    index_size, pos = _varint(footer, pos)
    for _, handle in _block_entries(_block(data, index_off, index_size,
                                           path)):
        off, p = _varint(handle, 0)
        size, _ = _varint(handle, p)
        yield from _block_entries(_block(data, off, size, path))


class TensorBundle:
    """The variables of a V2 checkpoint: ``names`` and
    ``get_tensor(name)``."""

    def __init__(self, prefix: str):
        index = prefix + '.index'
        if not os.path.exists(index):
            if os.path.isfile(prefix):
                raise ValueError(
                    '%s is a single-file (V1) checkpoint or not a checkpoint '
                    'prefix; this reader takes the V2 format, the prefix of '
                    '<prefix>.index and <prefix>.data-*' % prefix)
            raise FileNotFoundError('no %s' % index)
        self.prefix = prefix
        self.num_shards = 1
        self.entries: Dict[str, dict] = {}
        for key, value in _table_entries(index):
            if key == b'':
                self._header(value)
                continue
            self.entries[key.decode()] = self._entry(key.decode(), value)

    def _header(self, value) -> None:
        for num, _, v in _fields(value):
            if num == 1:
                self.num_shards = v
            elif num == 2 and v != 0:
                raise NotImplementedError('a big-endian tensor bundle')

    @staticmethod
    def _entry(name: str, value) -> dict:
        e = {'dtype': 0, 'shape': [], 'shard_id': 0, 'offset': 0, 'size': 0}
        for num, _, v in _fields(value):
            if num == 1:
                e['dtype'] = v
            elif num == 2:
                e['shape'] = _shape(v)
            elif num == 3:
                e['shard_id'] = v
            elif num == 4:
                e['offset'] = _signed(v)
            elif num == 5:
                e['size'] = _signed(v)
            elif num == 7:
                raise NotImplementedError(
                    '%s is a partitioned (sliced) variable' % name)
        return e

    @property
    def names(self) -> List[str]:
        return list(self.entries)

    def get_tensor(self, name: str) -> np.ndarray:
        e = self.entries[name]
        path = '%s.data-%05d-of-%05d' % (self.prefix, e['shard_id'],
                                         self.num_shards)
        with open(path, 'rb') as f:
            f.seek(e['offset'])
            raw = f.read(e['size'])
        if len(raw) != e['size']:
            raise ValueError('%s: %s runs past %s' % (self.prefix, name,
                                                      path))
        if e['dtype'] == DT_STRING:
            return self._strings(raw, e['shape'])
        return np.frombuffer(raw, _np_dtype(e['dtype'])).copy().reshape(
            e['shape'])

    @staticmethod
    def _strings(raw: bytes, shape: List[int]) -> np.ndarray:
        """A string tensor: the varint64 lengths, a 4-byte checksum of
        them, then the bytes."""
        n = int(np.prod(shape, dtype=np.int64))
        lengths, pos = [], 0
        for _ in range(n):
            v, pos = _varint(raw, pos)
            lengths.append(v)
        pos += 4
        out = []
        for v in lengths:
            out.append(raw[pos:pos + v])
            pos += v
        return np.array(out, dtype=object).reshape(shape)
