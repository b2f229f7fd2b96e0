"""A TensorBoard event-file writer without the tensorboard package
(counterpart of gandtr_tpu/learning/tensorboard.py; the reference's
Tensorboard streamer, eventprocessor.py:404-461, with absolute iteration
counters).

It writes `<directory>/epochs/tensorboard/events.out.tfevents.<time>.<host>`:
TFRecord framing (the length and the data, each followed by its masked
crc32c) around hand-encoded `tensorflow.Event` protos with scalar
summaries, which is what TensorBoard's scalars dashboard reads.
`read_scalar_events` parses such a file back and checks every CRC.
"""
import os
import socket
import struct
import time


def _crc_table():
    poly = 0x82F63B78   # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data):
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n):
    out = bytearray()
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out.append(b7 | 0x80)
        else:
            out.append(b7)
            return bytes(out)


def _field(num, wire, payload):
    return _varint((num << 3) | wire) + payload


def _len_field(num, payload):
    return _field(num, 2, _varint(len(payload)) + payload)


def encode_scalar_event(tag, value, step, wall_time=None):
    """tensorflow.Event {wall_time = 1, step = 2, summary = 5 {value = 1
    {tag = 1, simple_value = 2}}}."""
    value_msg = _len_field(1, tag.encode("utf8")) + \
        _field(2, 5, struct.pack("<f", float(value)))
    wall = time.time() if wall_time is None else wall_time
    return (_field(1, 1, struct.pack("<d", wall))
            + _field(2, 0, _varint(int(step)))
            + _len_field(5, _len_field(1, value_msg)))


def encode_file_version(wall_time=None):
    wall = time.time() if wall_time is None else wall_time
    return _field(1, 1, struct.pack("<d", wall)) + \
        _len_field(3, b"brain.Event:2")


def write_record(f, data):
    header = struct.pack("<Q", len(data))
    f.write(header + struct.pack("<I", masked_crc(header)) + data
            + struct.pack("<I", masked_crc(data)))


class TensorboardWriter:
    """A streamer of the EventBroker: each scalar event as it arrives, at
    the absolute step (epoch - 1) * epoch_size + iteration (the epoch's
    end, epoch * epoch_size, for an event without an iteration)."""

    def __init__(self, directory):
        logdir = os.path.join(directory, "epochs", "tensorboard")
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "events.out.tfevents.%d.%s"
                                 % (int(time.time()), socket.gethostname()))
        self._f = open(self.path, "ab")
        write_record(self._f, encode_file_version())
        self._epoch_sizes = {}

    def register(self, epoch, iteration, epoch_size, key, value, dtype):
        if not dtype.startswith("scalar"):
            return
        if epoch_size:
            self._epoch_sizes[key] = epoch_size
        size = self._epoch_sizes.get(key, 1)
        step = (epoch - 1) * size + (iteration if iteration is not None
                                     else size)
        write_record(self._f, encode_scalar_event(key, float(value), step))

    def close_epoch(self, epoch):
        self._f.flush()

    def close(self):
        self._f.close()


def read_records(path):
    """The data of each record of a TFRecord file; raises on a bad CRC or
    a cut record."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return out
            crc = f.read(4)
            if len(header) < 8 or len(crc) < 4 or \
                    struct.unpack("<I", crc)[0] != masked_crc(header):
                raise ValueError("bad record header in %s" % path)
            (length,) = struct.unpack("<Q", header)
            data, crc = f.read(length), f.read(4)
            if len(data) < length or len(crc) < 4 or \
                    struct.unpack("<I", crc)[0] != masked_crc(data):
                raise ValueError("bad record data in %s" % path)
            out.append(data)


def _fields(msg):
    """(number, wire type, value) of each field of a protobuf message:
    an int for varints, bytes for the others."""
    i, out = 0, []
    while i < len(msg):
        key, i = _read_varint(msg, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(msg, i)
        elif wire == 1:
            value, i = msg[i:i + 8], i + 8
        elif wire == 5:
            value, i = msg[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(msg, i)
            value, i = msg[i:i + n], i + n
        else:
            raise ValueError("wire type %d" % wire)
        out.append((num, wire, value))
    return out


def _read_varint(msg, i):
    v = shift = 0
    while True:
        b = msg[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def read_scalar_events(path):
    """[(tag, value, step)] of the scalar events of an event file, every
    record's CRCs checked."""
    events = []
    for data in read_records(path):
        step, tag, value = 0, None, None
        for num, _, v in _fields(data):
            if num == 2:
                step = v
            elif num == 5:
                for snum, _, sv in _fields(v):
                    if snum != 1:
                        continue
                    for vnum, _, vv in _fields(sv):
                        if vnum == 1:
                            tag = vv.decode("utf8")
                        elif vnum == 2:
                            (value,) = struct.unpack("<f", vv)
        if tag is not None:
            events.append((tag, value, step))
    return events
