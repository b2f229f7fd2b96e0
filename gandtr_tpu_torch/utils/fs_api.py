"""JSON-POST file-API client (counterpart of gandtr_tpu/utils/fs_api.py):
the reference daan ApiPath (mdir/external/daan/data/fs_driver.py:110-175)
on stdlib urllib.

URL grammar (same as the reference): `http(s)://[user:pass@]host/endpoint?
path=<base>[&k=v...]` — basic-auth credentials ride in the netloc, extra
query pairs become constant POST fields, and `path` is the filesystem base
the commands operate under. Commands: exists / makedirs / rename / read /
write (write is a multipart upload with a `file` part, matching the
reference's `requests.post(files=...)`).

`fs_driver(path)` mirrors fs_driver.py:177-183: http(s) URLs with a query
string get ApiPath, a plain http(s) URL goes to utils/io.py's fetch, which
raises (this package downloads nothing), anything else is a local path.
"""
import base64
import json
import posixpath
import urllib.request


class ApiPath:
    def __init__(self, url, *nested):
        if isinstance(url, dict):
            self.url, self.auth, self.data = url["url"], url["auth"], \
                dict(url["data"])
            path = url["path"]
        else:
            prot, _, host, path = url.split("/", 3)
            self.auth = None
            if "@" in host:
                self.auth = tuple(host.split("@")[0].split(":"))
                host = host.split("@")[1]
            self.data = {}
            if "?" in path:
                self.data = dict(x.split("=")
                                 for x in path.split("?")[1].split("&"))
                path = path.split("?")[0]
            self.url = prot + "//" + host + "/" + path
            path = self.data.pop("path")
        self.path = posixpath.join(path, *nested) if nested else path

    def __truediv__(self, other):
        return self.__class__({"url": self.url, "auth": self.auth,
                               "data": self.data, "path": self.path}, other)

    def _join(self, basename):
        return posixpath.join(self.path, basename) if basename else self.path

    def _request(self, additional, file_content=None):
        data = {**self.data, **additional}
        if file_content is not None:
            boundary = "----gandtr-tpu-api-path"
            body = b""
            for k, v in data.items():
                body += ("--%s\r\nContent-Disposition: form-data; "
                         'name="%s"\r\n\r\n%s\r\n' % (boundary, k,
                                                      json.dumps(v))).encode()
            body += ("--%s\r\nContent-Disposition: form-data; name=\"file\"; "
                     "filename=\"file\"\r\nContent-Type: "
                     "application/octet-stream\r\n\r\n"
                     % boundary).encode() + file_content + \
                ("\r\n--%s--\r\n" % boundary).encode()
            headers = {"Content-Type":
                       "multipart/form-data; boundary=%s" % boundary}
        else:
            body = json.dumps(data).encode()
            headers = {"Content-Type": "application/json"}
        if self.auth:
            headers["Authorization"] = "Basic " + base64.b64encode(
                (":".join(self.auth)).encode()).decode()
        req = urllib.request.Request(self.url, data=body, headers=headers,
                                     method="POST")
        return urllib.request.urlopen(req)

    def exists(self, *basenames):
        resp = self._request({"command": "exists",
                              "path": [self._join(x) for x in basenames]})
        return json.loads(resp.read())

    def makedirs(self, *basenames):
        resp = self._request({"command": "makedirs",
                              "path": [self._join(x) for x in basenames]})
        return json.loads(resp.read())

    def rename(self, src, dst):
        resp = self._request({"command": "rename", "src": self._join(src),
                              "dst": self._join(dst)})
        return json.loads(resp.read())

    def store(self, basename, content):
        resp = self._request({"command": "write",
                              "path": self._join(basename)},
                             file_content=content)
        return json.loads(resp.read())

    def open(self, basename=""):
        return self._request({"command": "read",
                              "path": self._join(basename)})


def fs_driver(path, *nested):
    """fs_driver.py:177-183 dispatch: api / http / local."""
    if path.startswith(("http://", "https://")):
        if "?" in path:
            return ApiPath(path, *nested)
        from gandtr_tpu_torch.utils.io import fetch
        return fetch("/".join((path.rstrip("/"),) + tuple(nested))
                     if nested else path)
    import os
    return os.path.join(path, *nested)
